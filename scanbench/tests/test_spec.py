"""The harness finds every configuration, mix and metric of BENCHMARK.json
by name, and the specification keeps to the benchmark's contract."""

import json
import re

import pytest

from scanbench.harness import loops, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.find_cell(BENCH, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.generator(), "make")
    loop, op = loops.resolve(cell)
    assert callable(loop.run) and callable(op.call)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_names_units_and_entries():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["source"]) <= 200
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert cfg["source"] == c["source"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "no.such_cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


MIX_CODE = """
from scanbench.harness import loops

OPS = {"count_twice": loops.Op(lambda sc, t: 2 * sc.count(t),
                               lambda ref, t: 2 * ref.count(t))}
"""


def _mix_cell(monkeypatch, tmp_path, mix: dict, code=None):
    """A cell of words1000 under a mix written to a scratch traffic/."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "probe.json").write_text(json.dumps(mix))
    if code is not None:
        (tmp_path / "traffic" / "probe.py").write_text(code)
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    return spec.make_cell(BENCH, {"name": "words1000.probe",
                                  "config": "words1000",
                                  "traffic": "probe", "chips": 1})


def test_a_mix_brings_its_own_operation(monkeypatch, tmp_path):
    cell = _mix_cell(monkeypatch, tmp_path, {"loop": "closed",
                                             "op": "count_twice"}, MIX_CODE)
    loop, op = loops.resolve(cell)
    assert loop is loops.LOOPS["closed"]
    assert op.call(type("S", (), {"count": lambda self, t: len(t)})(),
                   b"abc") == 6


@pytest.mark.parametrize("mix", [{"loop": "closed", "op": "count_twice"},
                                 {"loop": "bursty", "op": "count"}])
def test_unknown_op_or_loop_raises(monkeypatch, tmp_path, mix):
    cell = _mix_cell(monkeypatch, tmp_path, mix)
    with pytest.raises(KeyError, match="no (op|loop) named"):
        loops.resolve(cell)
