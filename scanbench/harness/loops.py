"""The traffic generator: the loops that drive the program, the operations
they call, and the reference's answer to each.

A mix is ``traffic/<mix>.json``: its ``loop`` and its ``op`` by name, the
sizes and the pool. A mix may bring ``traffic/<mix>.py`` beside it, whose
``LOOPS`` and ``OPS`` (dicts of ``Loop`` and ``Op`` by name) add to the
ones here, so that a new loop or operation is added as a file; a name that
neither knows raises.

- ``closed``: one client, calls back to back over a pool of ``pool``
  documents of ``doc_bytes`` bytes, cycled, until ``--seconds`` have passed;
  the call under way then finishes and counts.
- ``cycles``: the configuration's increments replayed from a new machine:
  insert one increment's keywords, bring the scanner live (``scanner()``
  the first time, ``refresh()`` after), count that increment's text of
  ``text_bytes``; a cycle starts only while time remains, and the window is
  whole cycles.

Each loop warms up with the very calls it will time, then measures;
``trace_from`` and ``trace_units`` (calls or cycles) bound the part of a
``--trace 1`` window that the profiler covers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import spec

# seeds' purposes (harness.gen.derive): the texts of a pool, of increments
POOL_TEXTS, INCREMENT_TEXTS = 10, 11


@dataclass
class Call:
    op: str
    t0: float
    t1: float
    nbytes: int
    doc: int
    answer: Any = None
    traced: bool = False
    error: Optional[str] = None


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    calls: list = field(default_factory=list)
    refreshed: list = field(default_factory=list)   # refresh() returns

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def units(self) -> int:
        """Calls or increments completed."""
        return len(self.calls)


def _equal(got, want) -> bool:
    return got == want


@dataclass(frozen=True)
class Op:
    """An operation a mix drives: ``call(scanner, text)`` is the program's
    answer as a user reads it, ``want(reference, text)`` the reference's,
    and ``same(got, want)`` decides whether they agree."""
    call: Callable
    want: Callable
    same: Callable = _equal


def _matches(sc, text):
    ms = sc.find_matches(text)
    # read out as a user would: every end and every keyword id
    return ms.ends, ms.ranks


def _same_matches(got, want) -> bool:
    ends, ids = got
    return (np.array_equal(np.asarray(ends, np.int64), want[0])
            and np.array_equal(np.asarray(ids, np.int64), want[1]))


OPS = {
    "count": Op(lambda sc, text: sc.count(text),
                lambda ref, text: ref.count(text)),
    "find_matches": Op(_matches, lambda ref, text: ref.matches(text),
                       _same_matches),
}


class Program:
    """The system under test, through its public API only, with a span
    around each call into it."""

    def __init__(self, act, spans, device, control: bool):
        self.act, self.spans = act, spans
        self.device = torch.device(device)
        self.control = control

    def begin(self) -> None:
        """The inputs are made: from here on the device's memory is the
        program's, so its peak starts anew."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def machine(self, increments, i0: int = 0):
        m = self.act.Machine()
        for i, inc in enumerate(increments):
            self.insert(m, inc, i0 + i)
        return m

    def insert(self, m, keywords, inc: int) -> None:
        with self.spans.span("insert_keywords", inc=inc):
            m.insert_keywords(keywords)

    def scanner(self, m, **kw):
        with self.spans.span("scanner"):
            return m.scanner(device=self.device, **kw)

    def refresh(self, sc) -> bool:
        with self.spans.span("refresh"):
            return sc.refresh()

    def call(self, sc, name: str, op: Op, text: bytes):
        with self.spans.span(name):
            return op.call(sc, text)


def _timed(prog: Program, sc, name: str, op: Op, text: bytes,
           doc: int) -> Call:
    t0 = time.perf_counter()
    try:
        ans, err = prog.call(sc, name, op, text), None
    except Exception as e:  # a failed call is counted, not fatal
        ans, err = None, f"{type(e).__name__}: {e}"
    return Call(name, t0, time.perf_counter(), len(text), doc, ans,
                error=err)


class _TraceWindow:
    """Starts the tracer at unit ``trace_from`` and stops it after
    ``trace_units`` units (or at the window's end)."""

    def __init__(self, tracer, traffic: dict):
        self.tracer = tracer
        self.first = int(traffic.get("trace_from", 0))
        self.last = self.first + int(traffic.get("trace_units", 1))

    def before(self, unit: int) -> bool:
        if self.tracer is None:
            return False
        if unit == self.first and not self.tracer.active:
            self.tracer.start()
        if unit == self.last and self.tracer.active:
            self.tracer.stop()
        return self.tracer.active

    def close(self) -> None:
        if self.tracer is not None and self.tracer.active:
            self.tracer.stop()


@dataclass(frozen=True)
class Loop:
    """``run(prog, dep, traffic, op, seconds, tracer, setup_done, seed)``
    drives the window and returns (Window, the program's state, the texts
    by index); ``want(ref, dep, op, texts, docs)`` is the reference's
    answer to each text index in ``docs``."""
    run: Callable
    want: Callable


def closed(prog: Program, dep, traffic: dict, op: Op, seconds: float,
           tracer, setup_done: Callable[[], None], seed: int) -> tuple:
    docs = dep.texts(traffic["pool"], traffic["doc_bytes"], POOL_TEXTS)
    prog.begin()
    m = prog.machine(dep.increments)
    sc = prog.scanner(m, **({"halo": 0} if prog.control else {}))
    name = traffic["op"]
    for d in range(int(traffic.get("warm_calls", 1))):
        prog.call(sc, name, op, docs[d % len(docs)])
    setup_done()
    tw, win = _TraceWindow(tracer, traffic), Window()
    win.t0 = time.perf_counter()
    i = 0
    while True:
        traced = tw.before(i)
        c = _timed(prog, sc, name, op, docs[i % len(docs)], i % len(docs))
        c.traced = traced
        win.calls.append(c)
        i += 1
        if c.t1 - win.t0 >= seconds:
            break
    win.t1 = win.calls[-1].t1
    tw.close()
    return win, (m, sc), docs


def want_each(ref, dep, op: Op, texts, docs) -> dict:
    return {d: op.want(ref, texts[d]) for d in docs}


def first_increment(increments) -> list:
    """The increment that first inserted each distinct keyword, in the
    reference's id order (first insertion)."""
    first: dict = {}
    for i, inc in enumerate(increments):
        for kw in inc:
            first.setdefault(bytes(kw), i)
    return list(first.values())


def cycles(prog: Program, dep, traffic: dict, op: Op, seconds: float,
           tracer, setup_done: Callable[[], None], seed: int) -> tuple:
    if traffic["op"] != "count":
        raise ValueError(f"the cycles loop counts; op {traffic['op']!r}")
    incs = dep.increments
    texts = dep.texts(len(incs), traffic["text_bytes"], INCREMENT_TEXTS)
    prog.begin()

    def one_cycle(win: Optional[Window], traced: bool):
        m = sc = None
        for i, inc in enumerate(incs):
            t0 = time.perf_counter()
            with prog.spans.span("increment", inc=i):
                if m is None:
                    m = prog.machine([inc], i)
                    sc = prog.scanner(m)
                else:
                    prog.insert(m, inc, i)
                    if not prog.control:   # the control leaves it stale
                        ok = prog.refresh(sc)
                        if win is not None:
                            win.refreshed.append(ok)
                c = _timed(prog, sc, "count", op, texts[i], i)
            c.t0, c.traced = t0, traced
            if win is not None:
                win.calls.append(c)
        return m, sc

    for _ in range(int(traffic.get("warm_cycles", 1))):
        one_cycle(None, False)
    setup_done()
    tw, win = _TraceWindow(tracer, traffic), Window()
    win.t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - win.t0 < seconds:
        traced = tw.before(n)
        state = None        # the last cycle's machine and scanner go first
        state = one_cycle(win, traced)
        n += 1
    win.t1 = time.perf_counter()
    tw.close()
    return win, state, texts


def want_live(ref, dep, op: Op, texts, docs) -> dict:
    """Increment i's count is that of the keywords inserted by then."""
    inc_of = np.asarray(first_increment(dep.increments))
    return {i: ref.count_by(texts[i], inc_of <= i) for i in docs}


LOOPS = {"closed": Loop(closed, want_each), "cycles": Loop(cycles, want_live)}


def resolve(cell: spec.Cell) -> "tuple[Loop, Op]":
    """The cell's loop and operation: the mix's own file's, else these."""
    mod = cell.traffic_module()
    loops = {**LOOPS, **getattr(mod, "LOOPS", {})}
    ops = {**OPS, **getattr(mod, "OPS", {})}
    name = cell.workload["traffic"]
    for what, key, known in (("loop", "loop", loops), ("op", "op", ops)):
        if cell.traffic[key] not in known:
            raise KeyError(f"mix {name!r}: no {what} named "
                           f"{cell.traffic[key]!r} (known: "
                           f"{', '.join(sorted(known))})")
    return loops[cell.traffic["loop"]], ops[cell.traffic["op"]]
