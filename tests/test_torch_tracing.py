"""The port's recorder (utils/profiling.py) and its span sites, on the CPU:
off it records nothing and hands out one shared no-op; on (``tracing()``
or a running ``torch.profiler``) spans nest by parent and call id, per
thread; the buffer is bounded and counts what it drops; the spans stand in
a ``device_trace`` as annotations inside their parents; the staging ring,
``refresh()``'s outcomes and the names keep to what the benchmark's
readers (``scanbench/metrics/``) expect."""

from __future__ import annotations

import json
import os
import re
import sys
import threading

import numpy as np
import pytest

from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "aho_corasick_1975_tpu_torch")
TEXT = b"To ushers: he found his pencil, but she could not find hers."


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset(profiling.MAX_RECORDS)
    yield
    profiling.reset(profiling.MAX_RECORDS)


def _machine(words=(b"he", b"she", b"his", b"hers")):
    m = Machine()
    m.insert_keywords(list(words))
    return m


def _names(recs) -> list:
    return [r["name"] for r in recs]


def test_off_records_nothing_and_allocates_no_span():
    sc = _machine().scanner(device="cpu", n_streams=4)
    assert sc.count(TEXT * 10) == 90
    assert len(sc.find_matches(TEXT)) == 9
    assert profiling.records() == []
    a, b = profiling.span("ac.count"), profiling.span("ac.decode")
    assert a is b and not a
    with a as sp:
        sp.note("bytes", 1)
    profiling.note("bytes", 1)
    assert profiling.records() == []


def test_spans_nest_by_parent_and_call():
    sc = _machine().scanner(device="cpu", n_streams=4)
    with profiling.tracing():
        assert profiling.span("ac.count")
        assert sc.count(TEXT * 10) == 90
        ms = sc.find_matches(TEXT)
        # the ranks come with the result, decoded on the device: reading
        # them opens no span of its own
        np.testing.assert_array_equal(
            ms.ranks, sc.tables.kw_rank[ms.end_states])
        assert ms.ranks.tolist() == [1, 0, 3, 0, 2, 1, 0, 0, 3]
    assert not profiling.span("ac.count")
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert _names(roots) == ["ac.count", "ac.find_matches"]
    for r in recs:
        assert r["t0"] <= r["t1"]
        if r["parent"] is None:
            assert r["call"] == r["id"]
            continue
        p = by_id[r["parent"]]
        assert r["call"] == p["call"] and r["thread"] == p["thread"]
        assert p["t0"] <= r["t0"] and r["t1"] <= p["t1"]
    count, find = roots[0], roots[1]
    assert count["counts"]["symbols"] == len(TEXT) * 10
    kids = {r["name"] for r in recs if r["call"] == count["id"]}
    assert {"ac.stage.wait", "ac.stage.fill"} <= kids
    kids = [r["name"] for r in recs if r["parent"] == find["id"]]
    assert "ac.readback" in kids and "ac.decode" in kids
    assert find["counts"]["events"] == 9 and find["counts"]["n_live"] > 0
    (decode,) = [r for r in recs if r["name"] == "ac.decode"]
    assert decode["counts"] == {"on_device": 1, "events": 9}


def test_parents_stay_apart_across_threads():
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with profiling.span(f"ac.test.{tag}"):
                barrier.wait()
                with profiling.span(f"ac.test.{tag}.child"):
                    barrier.wait()
        except Exception as e:  # reported below
            errors.append(e)

    with profiling.tracing():
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    by_name = {r["name"]: r for r in profiling.records()}
    assert len(by_name) == 4
    for tag in ("a", "b"):
        outer = by_name[f"ac.test.{tag}"]
        child = by_name[f"ac.test.{tag}.child"]
        assert child["parent"] == outer["id"] == child["call"]
        assert child["thread"] == outer["thread"]
    assert by_name["ac.test.a"]["thread"] != by_name["ac.test.b"]["thread"]


def test_many_threads_lose_no_span():
    """More threads than cores, switching often: every span is kept or
    counted as dropped, ids are unique and each child finds its parent."""
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    profiling.reset(capacity=n_threads * n_spans)     # 2 spans a loop
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_spans // 2):
            with profiling.span("ac.test.outer"):
                with profiling.span("ac.test.inner"):
                    pass

    try:
        with profiling.tracing():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    assert len(recs) + profiling.dropped() == n_threads * n_spans
    assert profiling.dropped() == 0
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        if r["name"] == "ac.test.inner":
            p = by_id[r["parent"]]
            assert p["name"] == "ac.test.outer"
            assert p["thread"] == r["thread"] and r["call"] == p["id"]


def test_buffer_drops_the_oldest_and_counts_them(tmp_path):
    profiling.reset(capacity=4)
    with profiling.tracing():
        for i in range(7):
            with profiling.span(f"ac.test.{i}"):
                pass
    assert _names(profiling.records()) == [f"ac.test.{i}"
                                           for i in range(3, 7)]
    assert profiling.dropped() == 3
    path = tmp_path / "spans.jsonl"
    assert profiling.dump(str(path)) == 4
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["name"] for r in lines] == _names(profiling.records())
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_phase_timer_records_through_the_buffer():
    t = profiling.PhaseTimer()
    with t.phase("scan"):
        with profiling.span("ac.inner"):   # off: not recorded
            pass
    recs = profiling.records()
    assert _names(recs) == ["scan"]
    assert t.report()["scan"]["calls"] == 1
    assert t.report()["scan"]["seconds"] == round(
        (recs[0]["t1"] - recs[0]["t0"]) / 1e9, 6)


def test_device_trace_holds_the_spans_inside_their_parents(tmp_path):
    sc = _machine().scanner(device="cpu", n_streams=4)
    with profiling.device_trace(str(tmp_path)):
        assert sc.count(TEXT * 10) == 90
        assert len(sc.find_matches(TEXT)) == 9
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    ann = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = {n for _, _, n in ann}
    assert {"ac.count", "ac.find_matches", "ac.stage.fill",
            "ac.readback", "ac.decode"} <= names

    def inside(name, parent):
        outer = [(a, b) for a, b, n in ann if n == parent]
        inner = [(a, b) for a, b, n in ann if n == name]
        assert inner and all(any(pa <= a and b <= pb for pa, pb in outer)
                             for a, b in inner)

    inside("ac.readback", "ac.find_matches")
    inside("ac.decode", "ac.find_matches")
    # the records of the same spans, on the profiler's side of the trace
    recs = profiling.records()
    assert _names([r for r in recs if r["parent"] is None]) == [
        "ac.count", "ac.find_matches"]


def test_each_chunk_of_a_pipelined_count_fills_and_waits_once(monkeypatch):
    monkeypatch.setattr(DenseScanner, "_pipeline_min", 1 << 10)
    monkeypatch.setattr(DenseScanner, "_pipeline_chunk", 1 << 9)
    m = _machine()
    sc = m.scanner(device="cpu", n_streams=4)
    text = TEXT * 40                                 # 2,440 bytes: 5 chunks
    with profiling.tracing():
        assert sc.count(text) == 9 * 40
    recs = profiling.records()
    (root,) = [r for r in recs if r["name"] == "ac.count"]
    kids = [r for r in recs if r["parent"] == root["id"]]
    chunks = -(-len(text) // (1 << 9))
    assert _names(kids).count("ac.stage.fill") == chunks
    assert _names(kids).count("ac.stage.wait") == chunks
    fills = [r["counts"]["bytes"] for r in kids
             if r["name"] == "ac.stage.fill"]
    assert all(b >= 1 << 9 for b in fills[:-1])
    assert [r["counts"]["slot"] for r in kids
            if r["name"] == "ac.stage.wait"] == [i % 2
                                                 for i in range(chunks)]


# find_matches' routes: K2's states decoded on the host where no packed
# k-gram table exists (a budget of 64 bytes), K4 and the refinement, the
# prefilter's K8 windows
ROUTES = {"states": dict(step_budget_bytes=64), "device": {},
          "sparse": dict(prefilter="on")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_find_matches_notes_its_route_and_states_nest_under_it(route):
    sc = _machine().scanner(device="cpu", n_streams=4, **ROUTES[route])
    assert (sc._snap.packed is None) == (route == "states")
    with profiling.tracing():
        ms = sc.find_matches(TEXT)
    assert len(ms) == 9
    recs = profiling.records()
    (find,) = [r for r in recs if r["name"] == "ac.find_matches"]
    assert find["parent"] is None and find["counts"]["route"] == route
    states = [r for r in recs if r["name"] == "ac.states"]
    (decode,) = [r for r in recs if r["name"] == "ac.decode"]
    assert decode["parent"] == find["id"]
    assert decode["counts"]["on_device"] == int(route != "states")
    if route != "states":
        assert not states
        return
    (st,) = states
    assert st["parent"] == find["id"] and st["call"] == find["id"]
    assert find["t0"] <= st["t0"] <= st["t1"] <= decode["t0"]
    assert st["counts"] == {"symbols": len(TEXT), "bytes": 4 * len(TEXT),
                            "table_bytes": sc._snap.dflat.nbytes}
    # called alone, scan_states is a root span of its own
    profiling.reset()
    with profiling.tracing():
        states = sc.scan_states(TEXT)
    assert len(states) == len(TEXT)
    recs = profiling.records()
    (st,) = [r for r in recs if r["parent"] is None]
    assert st["name"] == "ac.states" and st["call"] == st["id"]
    assert st["counts"]["bytes"] == states.nbytes
    assert all(r["call"] == st["id"] for r in recs)


def _refresh_record():
    (rec,) = [r for r in profiling.records() if r["name"] == "ac.refresh"]
    return rec


def test_refresh_records_its_outcome_and_work():
    m = _machine()
    sc = m.scanner(device="cpu", n_streams=4, step_k=2)
    m.insert_keywords([b"hi"])              # a state that exists, now a match
    with profiling.tracing():
        assert sc.refresh() is True
    rec = _refresh_record()
    assert rec["counts"]["outcome"] == "inplace"
    assert rec["counts"]["rows"] > 0 and rec["counts"]["cells"] > 0
    kids = {r["name"] for r in profiling.records()
            if r["parent"] == rec["id"]}
    assert {"ac.compile", "ac.refresh.diff"} <= kids
    assert "ac.snapshot.build" not in kids
    # the diff runs on the snapshot's device: its uploads of the new
    # 1-char tables are its children, and its bytes are theirs
    (diff,) = [r for r in profiling.records()
               if r["name"] == "ac.refresh.diff"]
    ups = [r for r in profiling.records() if r["name"] == "ac.upload"
           and r["parent"] == diff["id"]]
    tables = sc.tables
    assert diff["counts"]["on_device"] == 1
    assert diff["counts"]["bytes"] == sum(
        r["counts"]["bytes"] for r in ups) == (
        tables.delta.nbytes + tables.nb_outputs.nbytes)
    assert all(diff["t0"] <= r["t0"] <= r["t1"] <= diff["t1"] for r in ups)
    assert len(ups) == 2
    profiling.reset()
    m.insert_keywords([b"zebra"])           # new letters: the vocabulary grows
    with profiling.tracing():
        assert sc.refresh() is False
    rec = _refresh_record()
    assert rec["counts"]["outcome"] == "rebuild:vocab"
    kids = {r["name"] for r in profiling.records()
            if r["parent"] == rec["id"]}
    assert {"ac.compile", "ac.snapshot.build"} <= kids
    profiling.reset()
    with profiling.tracing():
        assert sc.refresh() is True         # nothing new
    assert _refresh_record()["counts"]["outcome"] == "noop"
    assert sc.count(TEXT) == _machine(
        (b"he", b"she", b"his", b"hers", b"hi", b"zebra")).scanner(
        device="cpu", n_streams=4).count(TEXT)


def test_insert_records_vocabulary_and_counts():
    m = Machine()
    with profiling.tracing():
        m.insert_keywords([b"abc", b"de"])
    recs = profiling.records()
    assert _names(recs) == ["ac.insert.vocab", "ac.insert"]
    assert recs[1]["counts"] == {"keywords": 2, "letters": 5}
    assert recs[0]["parent"] == recs[1]["id"]


def _source_names(path: str, pattern: str) -> set:
    found = set()
    for dirpath, _, files in os.walk(path):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    found |= set(re.findall(pattern, fh.read()))
    return found


def test_no_span_name_is_a_harness_span_name():
    program = _source_names(PKG, r'profiling\.span\("([^"]+)"\)')
    assert {"ac.count", "ac.stage.wait", "ac.stage.fill", "ac.launch",
            "ac.find_matches", "ac.refine", "ac.readback", "ac.decode",
            "ac.states",
            "ac.insert", "ac.insert.vocab", "ac.refresh", "ac.compile",
            "ac.refresh.diff", "ac.snapshot.build", "ac.upload",
            "ac.build"} == program
    # the benchmark's own spans: each public call by its operation's name
    # (scanbench/harness/loops.py), the rest by a literal, and the traced
    # part's mark (scanbench/harness/trace.py)
    bench = os.path.join(ROOT, "scanbench", "harness")
    harness = {"count", "find_matches", "insert_keywords", "scanner",
               "refresh", "increment", "scanbench.traced"}
    harness |= _source_names(bench, r'span\("([^"]+)"')
    harness |= _source_names(bench, r'WINDOW = "([^"]+)"')
    assert all(n.startswith("ac.") for n in program)
    assert not program & harness
