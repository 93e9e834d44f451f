"""The yardstick's bytes come from the configuration's own automaton, as
the plain reference builds it: one table entry a symbol, never more than
the reference's whole table, and nothing of how the program lays its
tables out."""

import pytest

from scanbench import roofline
from scanbench.harness import core
from scanbench.reference import Reference


@pytest.mark.parametrize("n,states,classes,table", [
    (100, 10, 28, 100),          # fewer symbols than entries
    (10**6, 10, 28, 280),        # never more than the table
    (64 << 20, 5148, 28, 5148 * 28),
])
def test_scan_bytes_one_entry_a_symbol_up_to_the_table(n, states, classes,
                                                        table):
    want = n + roofline.BYTE_LUT_BYTES + table * roofline.ENTRY_BYTES + 8
    assert roofline.scan_bytes(n, states, classes) == want


def test_geometry_is_the_reference_automaton():
    ref = Reference([b"he", b"she", b"his", b"hers"])
    # root, h, he, her, hers, hi, his, s, sh, she; classes e h i r s + other
    assert core.geometry(ref) == {"n_states": 10, "n_classes": 6}


def test_least_time_is_bound_by_bytes_or_operations():
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 1979e12) == pytest.approx(1.0)
