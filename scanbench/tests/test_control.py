"""The control: the program with a guarantee it states switched off comes
out not correct. Counting and retrieval run with no halo between streams
(an occurrence across a stream's edge is lost); the increments run without
refresh() (new keywords are not live). On the CPU at small sizes, and, on
the card, at each cell's own size on three seeds (``-m chip``)."""

import time

import pytest

from scanbench.harness import core, spec
from scanbench.tests import small


@pytest.mark.parametrize("cell", list(small.TRAFFIC))
def test_control_fails_small(cell):
    res = small.run(cell, control=True)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("seed", [8101, 8102, 2**31 + 8103])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_fails_at_cell_size(card, cell, seed):
    res = core.run_cell(cell, seed, 5.0, False, time.perf_counter(),
                        control=True)
    wrong = res["checks"]["wrong_answers"]["value"]
    print(f"control {cell} seed {seed}: wrong_answers {wrong} of "
          f"{res['attempted']}")
    assert res["correct"] is False and wrong > 0
