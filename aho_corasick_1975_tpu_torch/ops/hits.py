"""Two-phase match retrieval over the packed k-gram table.

Phase A is K4 (csrc/stepped_scan.cu), the count recurrence of K3 writing
one word per gram, ``(pre_state << count_bits) | gram_count``, beside its
plain PyTorch version; it replaces ``ops/hits.py:_stepped_emit_scan``
(``make_stepped_hits_scan`` / ``_raw``). A gram whose count is zero holds no
match end, so phase B refines only the live grams back into per-position
states. Phase B has no sequential chain, only bulk gathers, compaction and
scatter, and stays plain PyTorch here (``_compact``, ``hits_extract`` and
``hits_extract_dense``, the port of ``_hits_extract`` and
``_hits_extract_dense``).

The port's emit layout is stream-major, ``[B, L/k]`` body grams only (the
JAX package keeps ``[halo_steps + L/k, B]``), so its flat order is stream
order.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from . import build
from .multistep import check_stepped, combine_grams
from .scan_dense import window


def stepped_emit_plain(packed, V: int, k: int, count_bits: int,
                       halo_steps: int, B: int, L: int, ext, lut=None,
                       head_ids=None):
    """Plain K4: (emit int32 [B, L/k], n_hits int32 [B], n_live int32
    [B])."""
    grams = combine_grams(window(B, L, halo_steps * k, ext, lut, head_ids),
                          V, k)
    mask, Vk = (1 << count_bits) - 1, V ** k
    s = torch.zeros(B, dtype=torch.int64, device=ext.device)
    rows = []
    for j in range(grams.shape[0]):
        v = packed[s * Vk + grams[j]]
        if j >= halo_steps:
            rows.append((s << count_bits) | (v & mask))
        s = (v >> count_bits).long()
    emit = (torch.stack(rows, dim=1).to(torch.int32) if rows else
            torch.zeros((B, 0), dtype=torch.int32, device=ext.device))
    cnt = emit & mask
    return (emit, cnt.sum(dim=1, dtype=torch.int32),
            (cnt > 0).sum(dim=1, dtype=torch.int32))


def stepped_emit(packed, V: int, k: int, count_bits: int, halo_steps: int,
                 B: int, L: int, ext, lut=None, head_ids=None):
    """K4: (emit int32 [B, L/k], n_hits int32 [B], n_live int32 [B]); the
    caller sums the counts in int64."""
    dev = check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids)
    if dev.type == "cpu":
        return stepped_emit_plain(packed, V, k, count_bits, halo_steps, B, L,
                                  ext, lut, head_ids)
    emit = torch.empty((B, L // k), dtype=torch.int32, device=dev)
    n_hits = torch.empty(B, dtype=torch.int32, device=dev)
    n_live = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_stepped_emit", dev, table=packed, ext=ext, lut=lut,
                 head_ids=head_ids, out=emit, n_hits=n_hits, n_live=n_live,
                 L=L, Vk=V ** k, B=B, V=V, halo=halo_steps * k,
                 ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k,
                 count_bits=count_bits)
    return emit, n_hits, n_live


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Ascending int64 indices of the True entries, cut to ``size`` and
    padded with -1 (``jnp.nonzero(size=..., fill_value=-1)``)."""
    idx = torch.nonzero(mask).flatten()[:size]
    out = torch.full((size,), -1, dtype=torch.int64, device=mask.device)
    out[:idx.numel()] = idx
    return out


def hits_extract(V: int, k: int, count_bits: int, cap: int, out_size: int,
                 emit: torch.Tensor,
                 sym_at: Callable[[torch.Tensor], torch.Tensor],
                 dflat, nb_out) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Refine at most ``cap`` live grams of ``emit`` [B, L/k] into hit
    positions. ``sym_at(p)`` gives the int64 letter ids at body positions
    p. Returns (positions int64 [out_size] ascending, -1 padded; states
    int32 [out_size]; n_hit_pos, exact when the live grams fit cap)."""
    mask_c = (1 << count_bits) - 1
    Lkb = emit.shape[1]
    flat = emit.reshape(-1)                          # stream-order grams
    gidx = _compact((flat & mask_c) > 0, cap)
    valid = gidx >= 0
    safe = gidx.clamp(min=0)
    pos0 = (safe // Lkb) * (Lkb * k) + (safe % Lkb) * k
    s = (flat[safe] >> count_bits).long()            # pre-gram state
    states_j, cnt_j = [], []
    for j in range(k):
        s = dflat[s * V + sym_at(pos0 + j)].long()
        states_j.append(s)
        cnt_j.append(nb_out[s])
    states_ck = torch.stack(states_j, dim=1)         # [cap, k]
    hit = (torch.stack(cnt_j, dim=1) > 0) & valid[:, None]
    n_hit_pos = int(hit.sum())
    fidx = _compact(hit.reshape(-1), out_size)
    fvalid = fidx >= 0
    fsafe = fidx.clamp(min=0)
    pos_ck = pos0[:, None] + torch.arange(k, device=emit.device)[None, :]
    positions = torch.where(fvalid, pos_ck.reshape(-1)[fsafe], -1)
    sts = torch.where(fvalid, states_ck.reshape(-1)[fsafe], 0)
    return positions, sts.to(torch.int32), n_hit_pos


def hits_extract_dense(V: int, k: int, count_bits: int, cb1: int,
                       max_hits: int, pk1, emit: torch.Tensor,
                       syms: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Phase B for match-dense corpora: refine EVERY position through the
    packed k=1 table ``pk1`` ((next_state << cb1) | nb); ``syms`` int64
    [B, L] body letter ids. Same returns as hits_extract, with
    ``max_hits`` output slots."""
    m1 = (1 << cb1) - 1
    B, Lkb = emit.shape
    s = (emit >> count_bits).long()                  # pre-gram states
    sy = syms.reshape(B, Lkb, k)
    parts = []
    for j in range(k):
        v = pk1[s * V + sy[:, :, j]]
        s = (v >> cb1).long()
        parts.append((s << 1) | ((v & m1) > 0).long())
    flat = torch.stack(parts, dim=2).reshape(-1)     # stream order
    hit = (flat & 1) > 0
    n_hit_pos = int(hit.sum())
    positions = _compact(hit, max_hits)
    states = torch.where(positions >= 0, flat[positions.clamp(min=0)] >> 1,
                         0)
    return positions, states.to(torch.int32), n_hit_pos
