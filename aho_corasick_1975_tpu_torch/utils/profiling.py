"""The port's one recorder of spans and counts, and its device trace.

A span is one piece of work at a layer boundary: its name (every name the
program records starts with ``ac.``), start and end on
``time.perf_counter_ns()``, the id of the span that caused it (``parent``),
the id of the outermost span of the same public call on the same thread
(``call``) and a small dict of counts (``counts``: bytes, chunks, rows,
cells, launches, an outcome). Parents are kept per thread, since scanners
are called from several threads at once. Closed spans go into a bounded
in-memory buffer (``MAX_RECORDS``); the oldest go first when it is full,
and ``dropped()`` counts them.

The recorder is on while a ``torch.profiler`` profile runs in the process
(``torch.autograd._profiler_enabled()``), or inside ``with tracing():``,
and off otherwise. Off, a span site costs one check and allocates nothing:
``span()`` hands back one shared object that does nothing. While a
profiler runs, each span is also a ``torch.profiler.record_function``
annotation of the same name, so the spans stand in the device trace on
its clock, beside the kernels and copies.

* ``span(name)``: the context manager of a span site; ``.note(key,
  value)`` sets a count on it, and a span is true only while it records,
  so that a site computes a costly count only then;
* ``note(key, value)``: a count on this thread's innermost open span;
* ``records()``, ``dump(path)`` (JSONL), ``dropped()``, ``reset()``;
* ``PhaseTimer``: named wall-clock phases (build / upload / scan /
  decode), a view over the recorder: each phase is a span that records
  whether or not the recorder is on, and ``report()`` sums them by name;
* ``device_trace``: a ``torch.profiler`` trace of the CPU and, where the
  machine has one, the CUDA device around any scan call, written into
  ``logdir`` as a Chrome trace; the spans inside it are its annotations.
  PyTorch returns before the device finishes, so a span around device
  work ends when the host stops waiting: a synchronous read of a result
  (``int(...)``, ``.cpu()``) ends it after the device.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

import torch

MAX_RECORDS = 65536

_profiler_enabled = torch.autograd._profiler_enabled
_now = time.perf_counter_ns


class _Recorder:
    """The process's buffer of closed spans, and the ``tracing()`` depth."""

    def __init__(self, capacity: int):
        self.buffer: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.forced = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans' records, innermost last."""
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def store(self, rec: dict) -> None:
        with self.lock:
            if len(self.buffer) == self.buffer.maxlen:
                self.dropped += 1
            self.buffer.append(rec)


_rec = _Recorder(MAX_RECORDS)


class _Span:
    """A span that records: made only when the recorder is on, or by a
    ``PhaseTimer``."""

    __slots__ = ("rec", "_ann", "_sink")

    def __init__(self, name: str, sink=None):
        self.rec = {"name": name, "counts": {}}
        self._ann = None
        self._sink = sink

    def __bool__(self) -> bool:
        return True

    def note(self, key: str, value) -> None:
        self.rec["counts"][key] = value

    def __enter__(self) -> "_Span":
        rec = self.rec
        stack = _rec.stack()
        rec["id"] = next(_rec.ids)
        if stack:
            rec["parent"], rec["call"] = stack[-1]["id"], stack[-1]["call"]
        else:
            rec["parent"], rec["call"] = None, rec["id"]
        rec["thread"] = threading.get_ident()
        stack.append(rec)
        if _profiler_enabled():
            self._ann = torch.profiler.record_function(rec["name"])
            self._ann.__enter__()
        rec["t0"] = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.rec
        rec["t1"] = _now()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        _rec.stack().pop()
        _rec.store(rec)
        if self._sink is not None:
            self._sink(rec)
        return False


class _Off:
    """The span of every site while the recorder is off: it does nothing
    and is false."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def note(self, key: str, value) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """The span ``name`` around a ``with`` block: a recording span while
    the recorder is on, else the shared no-op."""
    if _rec.forced or _profiler_enabled():
        return _Span(name)
    return _OFF


def note(key: str, value) -> None:
    """Set count ``key`` on this thread's innermost open span, if the
    recorder is on and a span is open."""
    if _rec.forced or _profiler_enabled():
        stack = _rec.stack()
        if stack:
            stack[-1]["counts"][key] = value


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record every span site in the process inside the block, with no
    profiler running."""
    with _rec.lock:
        _rec.forced += 1
    try:
        yield
    finally:
        with _rec.lock:
            _rec.forced -= 1


def records() -> list:
    """The closed spans in the buffer, oldest first: dicts of ``name``,
    ``id``, ``parent``, ``call``, ``thread``, ``t0``, ``t1`` (ns on
    ``time.perf_counter_ns()``) and ``counts``."""
    with _rec.lock:
        return list(_rec.buffer)


def dropped() -> int:
    """Spans pushed out of the full buffer since the last ``reset()``."""
    return _rec.dropped


def dump(path: str) -> int:
    """Write the buffer to ``path`` as JSONL, one span a line; returns the
    number of lines."""
    recs = records()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r, default=str) + "\n")
    return len(recs)


def reset(capacity: Optional[int] = None) -> None:
    """Empty the buffer and zero ``dropped()``; ``capacity`` sets a new
    bound (default: the current one)."""
    with _rec.lock:
        _rec.buffer = deque(maxlen=capacity or _rec.buffer.maxlen)
        _rec.dropped = 0


class PhaseTimer:
    """Named wall-clock phases, each a span of the recorder that records
    whether or not the recorder is on; ``report()`` gives each name's
    summed seconds and calls."""

    def __init__(self):
        self._ns: Dict[str, int] = defaultdict(int)
        self._calls: Dict[str, int] = defaultdict(int)

    def _add(self, rec: dict) -> None:
        self._ns[rec["name"]] += rec["t1"] - rec["t0"]
        self._calls[rec["name"]] += 1

    def phase(self, name: str) -> _Span:
        return _Span(name, sink=self._add)

    def report(self) -> Dict[str, dict]:
        return {k: {"seconds": round(v / 1e9, 6), "calls": self._calls[k]}
                for k, v in sorted(self._ns.items())}


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace around a block, CUDA activity included
    where CUDA is present; the Chrome trace goes to
    ``logdir/trace_<pid>_<ns>.json`` (open it in chrome://tracing or
    Perfetto). Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
