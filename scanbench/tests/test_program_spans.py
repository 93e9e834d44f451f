"""The program's own spans read through the benchmark
(``harness/program.py`` and the readers over it), on the CPU: a traced run
reads the span metrics of its cell, an untraced run none, a program
without the recorder none and no error; the program's spans lie inside
the harness's, on one clock, in the profiler's trace and in the records
written beside it."""

import json

import pytest

from scanbench.harness import spec
from scanbench.tests import small

BENCH = spec.load_benchmark()
NEW = ("count.fill_ms", "count.slot_wait_ms", "count.self_ms",
       "count.launches", "retrieve.refine_ms", "retrieve.readback_ms",
       "retrieve.decode_ms", "increment.vocab_ms", "increment.compile_ms",
       "increment.diff_ms", "increment.rebuild_ms", "increment.upload_ms")
# Not on the CPU: no kernel is launched there (ops/build.py:launch is the
# card's), and at the small size every refresh rebuilds, whose tables the
# CPU keeps without an upload.
NOT_ON_CPU = {"count.launches", "increment.upload_ms"}
CELLS = [w["name"] for w in BENCH["workloads"]]
# the retrieval's traced calls are its second and third: time for both
SECONDS = {"words1000.retrieve_64m": 3.0}
HARNESS_SPAN = {"ac.count": "count", "ac.find_matches": "find_matches",
                "ac.refresh": "refresh"}


def _new(cell) -> set:
    return {m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}


def _run(cell, **kw):
    return small.run(cell, seconds=SECONDS.get(cell, 0.5), **kw)


def test_the_new_entries_are_the_programs():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(NEW) <= set(entries)
    for name in NEW:
        m = entries[name]
        assert m["source"] == ("program_counter" if name == "count.launches"
                               else "program_span")
        assert m["unit"] == ("launches" if name == "count.launches"
                             else "ms")
        assert len(m["workloads"]) == 1 and m["workloads"][0] in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(cell):
    res = _run(cell, trace=True)
    assert res["correct"]
    want = _new(cell) - NOT_ON_CPU
    assert want and want <= set(res["metrics"])
    assert not (NOT_ON_CPU & set(res["metrics"]))
    for name in want:
        assert res["metrics"][name]["value"] >= 0
    with open(spec.OUT_DIR / f"{cell}.program_spans.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert recs and all(r["name"].startswith("ac.") for r in recs)
    assert {r["harness_call"] for r in recs} <= set(range(res["attempted"]))
    untraced = _run(cell, trace=False)
    assert untraced["correct"] and not _new(cell) & set(untraced["metrics"])


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from aho_corasick_1975_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    res = _run("words1000.count_64m", trace=True)
    assert res["correct"] and "breakdown" in res
    assert not _new("words1000.count_64m") & set(res["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_program_spans_lie_inside_the_harness_spans(cell):
    _run(cell, trace=True)
    with open(spec.OUT_DIR / f"{cell}.trace.json") as f:
        events = json.load(f)["traceEvents"]
    ann = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    seen = 0
    for ours, theirs in HARNESS_SPAN.items():
        outer = [(a, b) for a, b, n in ann if n == theirs]
        for a, b, n in ann:
            if n == ours:
                seen += 1
                assert any(pa <= a and b <= pb for pa, pb in outer), (n, a)
    assert seen
