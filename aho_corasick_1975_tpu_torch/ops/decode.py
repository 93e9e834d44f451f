"""Match decoding: per-position states -> (position, keyword) tuples.

The NumPy functions are the port's copy of
``aho_corasick_1975_tpu/ops/decode.py``: the host decode of the mesh
scanner and of the full-state fallback, and the tests' oracle.
``expand_hits_device`` is their torch counterpart for hits already on the
device, which the single-device retrieval decodes there before it reads
back only the events' columns.

The reference retrieves matches by walking the fail chain at scan time
(acm_get_match, aho_corasick.c:450-482: index-th end-of-keyword state along
the chain, index 0 = longest). Here the chain walk was precomputed at table
build into the emit CSR (core/builder.py: emit_start/emit_state, each state's
end-states listed longest-first), so decoding is pure vectorized numpy over
the scan's state outputs — the two-phase count+expand replacing pointer
chasing (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.builder import DenseTables


class MatchEvent(NamedTuple):
    """One keyword occurrence.

    end: 0-based index of the last matched symbol in the stream.
    start: 0-based index of the first matched symbol (end - length + 1).
    end_state: automaton end-of-keyword state identifying the keyword.
    index: per-position match index, 0 = longest (reference API order).
    """

    end: int
    start: int
    end_state: int
    index: int


def expand_hits_arrays(positions: np.ndarray, states: np.ndarray,
                       tables: DenseTables, offset: int = 0):
    """Vectorized CSR expansion of (position, landing-state) hits into the
    columnar event representation (the whole acm_get_match fail-chain walk,
    ref c:457-482, as three numpy gathers — no per-event Python).

    positions must be sorted ascending; each position's landing state emits
    nb_outputs[state] events, longest keyword first (emit CSR order).
    Returns (ends int64 [E], end_states int32 [E], indices int32 [E])."""
    positions = np.asarray(positions)
    states = np.asarray(states)
    counts = tables.nb_outputs[states].astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    ends = np.repeat(positions.astype(np.int64), counts) + offset
    # per-position 0..count-1 index ramp
    idx = (np.arange(total, dtype=np.int64)
           - np.repeat(np.cumsum(counts) - counts, counts))
    emit_idx = np.repeat(tables.emit_start[states].astype(np.int64),
                         counts) + idx
    end_states = tables.emit_state[emit_idx]
    return ends, end_states, idx.astype(np.int32)


class DecodeTables(NamedTuple):
    """The decode's tables on a device, int32 each: ``DenseTables``'
    fields of the same names."""

    nb_outputs: torch.Tensor
    emit_start: torch.Tensor
    emit_state: torch.Tensor
    kw_rank: torch.Tensor


def expand_hits_device(positions: torch.Tensor, states: torch.Tensor,
                       T: int, dec: DecodeTables, offset: int = 0):
    """``expand_hits_arrays`` on the hits' device, with each event's
    keyword rank: (ends int64, end_states int32, indices int32, ranks
    int32), tensors of exactly E entries, element for element the host
    decode's.

    ``positions`` must be ascending before their tail of -1 pads, with
    those at or past ``T`` last among the real ones: the order in which
    both refinements and K8 return them (stream order). The kept hits are
    then a prefix, cut at its count; the count and E are the one host
    synchronisation."""
    keep = (positions >= 0) & (positions < T)
    counts = torch.where(keep, dec.nb_outputs[states.long()], 0)
    n, total = torch.stack([keep.sum(), counts.sum()]).tolist()
    counts = counts[:n].long()
    hit = torch.repeat_interleave(counts, output_size=total)
    # per-position 0..count-1 index ramp
    idx = (torch.arange(total, device=positions.device)
           - (torch.cumsum(counts, 0) - counts)[hit])
    ends = positions[:n].long()[hit] + offset
    emit_idx = dec.emit_start[states[:n].long()][hit].long() + idx
    end_states = dec.emit_state[emit_idx]
    return (ends, end_states, idx.to(torch.int32),
            dec.kw_rank[end_states.long()])


def decode_matches_arrays(states: np.ndarray, tables: DenseTables,
                          offset: int = 0):
    """Columnar decode of a full per-position state stream: returns
    (ends int64, end_states int32, indices int32) ordered by end position,
    longest first within a position (acm_get_match index order)."""
    states = np.asarray(states)
    counts = tables.nb_outputs[states]
    (hit_pos,) = np.nonzero(counts)
    return expand_hits_arrays(hit_pos, states[hit_pos], tables, offset)


def decode_matches(states: np.ndarray, tables: DenseTables,
                   offset: int = 0) -> List[MatchEvent]:
    """Expand scan states into match events.

    states[t] = automaton state after consuming symbol t (scan output).
    Events are ordered by end position; within a position, longest keyword
    first (acm_get_match index order, ref c:459-466). ``offset`` shifts
    reported positions (shard-local -> absolute stream positions).

    Returns a Python list; scanners return the columnar ``MatchSet``
    (models/results.py) instead, which skips this materialization."""
    ends, end_states, idx = decode_matches_arrays(states, tables, offset)
    lengths = tables.depth[end_states]
    starts = ends - lengths + 1
    return [MatchEvent(e, s, st, i)
            for e, s, st, i in zip(ends.tolist(), starts.tolist(),
                                   end_states.tolist(), idx.tolist())]
