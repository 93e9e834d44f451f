"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU runs the program's plain
versions) and the rest of the run is driven as the chip runs it, with one
fault planted at a time where the program produces its answer."""

import pytest

from aho_corasick_1975_tpu_torch.models.scanner import DenseScanner
from scanbench.harness import spec
from scanbench.tests import small

CELLS = list(small.TRAFFIC)
count, find_matches = DenseScanner.count, DenseScanner.find_matches


def altered_count(self, signs, head=None):
    """An answer altered where it is produced."""
    return count(self, signs, head) + 1


def half_count(self, signs, head=None):
    """Half of the input left out."""
    return count(self, signs[:len(signs) // 2], head)


def altered_matches(self, signs, offset=0, head=None, max_hits=None):
    ms = find_matches(self, signs, offset, head, max_hits)
    ms.ends = ms.ends.copy()
    ms.ends[len(ms.ends) // 2] += 1
    return ms


def half_matches(self, signs, offset=0, head=None, max_hits=None):
    return find_matches(self, signs[:len(signs) // 2], offset, head,
                        max_hits)


def unchanged_refresh(self):
    """A step that leaves its state unchanged."""
    return True


FAULTS = {
    "altered_answer": {"count": altered_count,
                       "find_matches": altered_matches},
    "half_left_out": {"count": half_count, "find_matches": half_matches},
    "state_unchanged": {"refresh": unchanged_refresh},
}


def cases():
    for cell in CELLS:
        op = "find_matches" if "retrieve" in cell else "count"
        yield cell, "altered_answer", op
        yield cell, "half_left_out", op
        if "increments" in cell:
            yield cell, "state_unchanged", "refresh"


@pytest.mark.parametrize("cell,fault,method", list(cases()))
def test_fault_is_not_correct(monkeypatch, cell, fault, method):
    monkeypatch.setattr(DenseScanner, method, FAULTS[fault][method])
    res = small.run(cell)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = small.run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


def test_raising_call_is_a_failed_call(monkeypatch):
    def boom(self, signs, head=None):
        raise RuntimeError("planted")
    monkeypatch.setattr(DenseScanner, "count", boom)
    with pytest.raises(RuntimeError):
        small.run("words1000.count_64m")   # the warm-up raises first


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_host_metrics(cell):
    """A traced run on the CPU has no device activity: the readers of the
    device trace give nothing (never 0 for a share), the others read."""
    res = small.run(cell, trace=True)
    names = {m["name"] for m in spec.load_benchmark()["per_layer"]
             if cell in m["workloads"]}
    host = {n for n in names if n in ("increment.insert_ms",
                                      "increment.refresh_ms",
                                      "increment.inplace_share")}
    assert set(res["metrics"]) == host
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]
