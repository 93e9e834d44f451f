"""The yardstick's arithmetic: the least time a scan's work needs on one
NVIDIA H100, and the card's published peaks.

The rule is the one the port's kernel table uses: each input byte read
once, each output byte written once, and of the tables the entries the walk
needs: one entry a symbol, never more than the full transition table of the
configuration's own automaton (its states times its letter classes, as the
plain reference builds it). Nothing here reads how the program lays its
tables out or how many symbols it takes a step, so the work is the same
whatever kernel does it, and replacing a kernel does not make a share
stale. A scan's least time is
bound by the bytes; a DFA walk does a few integer operations per step,
which no published peak of the card binds.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense rates, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

ENTRY_BYTES = 4          # one int32 table entry
BYTE_LUT_BYTES = 256 * 4  # the raw bytes' letter ids


def scan_bytes(n_symbols: int, n_states: int, n_classes: int,
               out_bytes: int = 8) -> int:
    """Bytes a count (or emit) over ``n_symbols`` raw bytes needs with an
    automaton of ``n_states`` states over ``n_classes`` letter classes: the
    input once, the byte LUT once, one table entry a symbol up to the
    table's ``n_states * n_classes`` entries, and ``out_bytes`` of
    result."""
    table = min(n_symbols, n_states * n_classes) * ENTRY_BYTES
    return n_symbols + BYTE_LUT_BYTES + table + out_bytes


def least_seconds(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time for ``n_bytes`` moved and ``n_ops`` int8
    operations: whichever binds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S)
