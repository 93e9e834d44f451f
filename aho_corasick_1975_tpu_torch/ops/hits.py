"""Match retrieval: two-phase over the packed k-gram table, and K8, the
1-char bounded hits.

Phase A is K4 (csrc/stepped_scan.cu), the count recurrence of K3 writing
one word per gram, ``(pre_state << count_bits) | gram_count``, beside its
plain PyTorch version; it replaces ``ops/hits.py:_stepped_emit_scan``
(``make_stepped_hits_scan`` / ``_raw``). On the card it runs K3's
sub-streams, each warmed up over ``warm_steps`` grams, here
``multistep.emit_warm_steps_for``: one symbol more than the counts need,
since a gram's word holds the state before it. A gram whose count is zero
holds no match end, so phase B refines only the live grams back into
per-position states. Phase B has no sequential chain, only bulk gathers,
compaction and scatter, and stays plain PyTorch here (``_compact``,
``hits_extract`` and ``hits_extract_dense``, the port of
``_hits_extract`` and ``_hits_extract_dense``).

The port's emit layout is stream-major, ``[B, L/k]`` body grams only (the
JAX package keeps ``[halo_steps + L/k, B]``), so its flat order is stream
order.

K8 (csrc/sparse_scan.cu) is the retrieval of scanners without a packed
table and of the sparse prefilter: the 1-char recurrence, a position
hitting where ``nb_out[state] > 0`` past the halo. ``dense_hits`` runs it
over the streams of ``ops/scan_dense.py`` (``ops/hits.py:make_blocked_hits``
/ ``_stream`` / ``_raw``), ``window_hits`` over the live-block windows of
``ops/sparse.py`` (``_window_hits_core``: ``make_sparse_hits[_dev]``,
``make_elided_hits``). The reference compacts a hit mask into a buffer of
``max_hits`` slots, which its prefilter sizes to ``pow2(n_live * L_blk)``
(ROADMAP C4). K8 runs each column as P sub-streams (K1's, warmed up over
``warm_steps`` symbols: ``scan_dense.dense_fields``), counts each
sub-stream's hits in a first pass, then writes them at their sub-streams'
offsets (an exclusive cumsum) in a second at the same P, so its outputs
hold exactly the hit positions, in stream order: 8 bytes each.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import build
from .multistep import check_stepped, combine_grams, split_fields
from .scan_dense import check_stream, dense_fields, window
from .sparse import check_windows, window_fields, window_gather


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
                 B: int, L: int, ext, lut=None, head_ids=None, *,
                 warm_steps: int, split: int = 0):
    """K4: (emit int32 [B, L/k], n_hits int32 [B], n_live int32 [B]); the
    caller sums the counts in int64. On the card each stream runs as
    ``split`` sub-streams (``multistep.split_fields``), each warmed up over
    ``warm_steps`` grams, ``emit_warm_steps_for`` of the tables."""
    dev = check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids)
    sub = split_fields(V, k, warm_steps, split)
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
                 count_bits=count_bits, **sub)
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


def max_hits_error(n_hit_pos: int, max_hits: int) -> ValueError:
    return ValueError(
        f"{n_hit_pos} matching positions exceed max_hits={max_hits}; raise "
        "max_hits or chunk the stream with a session")


def _hits_plain(dflat, nb_out, V: int, halo: int, win: torch.Tensor,
                pos0: torch.Tensor):
    """Plain K8 over [halo + L, n] letter ids whose column c starts at
    stream position pos0[c]: (positions int32, states int32, n_hits,
    n_hit_pos), stream order."""
    s = torch.zeros(win.shape[1], dtype=torch.int64, device=win.device)
    rows = []
    for t in range(win.shape[0]):
        s = dflat[s * V + win[t]].long()
        if t >= halo:
            rows.append(s)
    L = win.shape[0] - halo
    states = (torch.stack(rows, dim=1) if rows else torch.zeros(
        (win.shape[1], 0), dtype=torch.int64, device=win.device))
    counts = nb_out[states]                          # [n, L], stream order
    hit = counts > 0
    pos = pos0.long()[:, None] + torch.arange(L, device=win.device)[None, :]
    return (pos[hit].to(torch.int32), states[hit].to(torch.int32),
            int(counts.sum(dtype=torch.int64)), int(hit.sum()))


def _bounded(out, max_hits: Optional[int]):
    if max_hits is not None and out[3] > max_hits:
        raise max_hits_error(out[3], max_hits)
    return out


def _hits_two_pass(name: str, dev, n_cols: int, max_hits: Optional[int],
                   form: str, **fields):
    """Run K8 entry point ``name`` twice over n_cols columns of P
    sub-streams, P asked of its launcher once (``build.launch_split``) and
    forced on both passes: pass 1 counts per sub-stream, pass 2 writes
    exactly the hits (raising past ``max_hits`` before it)."""
    fields["split"] = P = build.launch_split(name, dev, **fields)
    n_hits_c = torch.empty(n_cols * P, dtype=torch.int32, device=dev)
    n_pos_c = torch.empty(n_cols * P, dtype=torch.int32, device=dev)
    build.launch(name, dev, form, n_hits=n_hits_c, n_live=n_pos_c, **fields)
    n_hits, n_hit_pos = torch.stack([n_hits_c.sum(dtype=torch.int64),
                                     n_pos_c.sum(dtype=torch.int64)]).tolist()
    if max_hits is not None and n_hit_pos > max_hits:
        raise max_hits_error(n_hit_pos, max_hits)
    positions = torch.empty(n_hit_pos, dtype=torch.int32, device=dev)
    states = torch.empty(n_hit_pos, dtype=torch.int32, device=dev)
    if n_hit_pos:
        offsets = torch.cumsum(n_pos_c, 0, dtype=torch.int64) - n_pos_c
        build.launch(name, dev, form, hit_pos=positions, hit_state=states,
                     hit_off=offsets, **fields)
    return positions, states, n_hits, n_hit_pos


def dense_hits_plain(dflat, nb_out, V: int, halo: int, B: int, L: int, ext,
                     lut=None, head_ids=None):
    """Plain K8 stream form: (positions int32, states int32, n_hits,
    n_hit_pos); positions b*L + t in stream order."""
    return _hits_plain(dflat, nb_out, V, halo,
                       window(B, L, halo, ext, lut, head_ids),
                       torch.arange(B, device=ext.device) * L)


def dense_hits(dflat, nb_out, V: int, halo: int, B: int, L: int, ext,
               lut=None, head_ids=None, max_hits: Optional[int] = None, *,
               warm_steps: int, split: int = 0,
               n_states: Optional[int] = None, global_table: bool = False):
    """K8 stream form over the streams of ``ops/scan_dense.py``: the hit
    positions (b*L + t, stream order; the caller trims those past the
    stream) and their states, int32 tensors of exactly n_hit_pos entries,
    with n_hits (matches) and n_hit_pos. Raises ValueError past
    ``max_hits``. Sub-stream fields as K1's (``dense_fields``)."""
    dev = check_stream(B, L, halo, ext, lut, head_ids, dflat, nb_out)
    sub = dense_fields(dflat, V, warm_steps, split, n_states, global_table)
    if dev.type == "cpu":
        return _bounded(dense_hits_plain(dflat, nb_out, V, halo, B, L, ext,
                                         lut, head_ids), max_hits)
    return _hits_two_pass(
        "ac_dense_hits", dev, B, max_hits, "raw" if lut is not None
        else "ids", table=dflat, nb_out=nb_out, ext=ext, lut=lut,
        head_ids=head_ids, L=L, B=B, V=V, halo=halo,
        ext_u8=int(ext.dtype == torch.uint8),
        n_lut=0 if lut is None else lut.numel(), **sub)


def window_hits_plain(dflat, nb_out, V: int, halo: int, L_blk: int, src,
                      idx):
    """Plain K8 window form: hits of the windows of ``src`` (index list or
    elided windows, ``ops/sparse.py``) at positions idx[c]*L_blk + t."""
    return _hits_plain(dflat, nb_out, V, halo,
                       window_gather(src, idx, L_blk, halo),
                       idx.long() * L_blk)


def window_hits(dflat, nb_out, V: int, halo: int, L_blk: int, src, idx,
                max_hits: Optional[int] = None, *, warm_steps: int,
                split: int = 0, n_states: Optional[int] = None,
                global_table: bool = False):
    """K8 window form: as ``dense_hits``, over live-block windows; idx
    [n] int32 gives each window's block (ascending, so the output is in
    stream order). Pad windows hold no hit."""
    if idx is None or idx.dim() != 1 or idx.dtype != torch.int32 or (
            src.dim() == 2 and idx.numel() != src.shape[1]):
        raise ValueError("window hits need idx, int32, one per window")
    dev = check_windows(L_blk, halo, src, idx, dflat, nb_out)
    sub = dense_fields(dflat, V, warm_steps, split, n_states, global_table)
    if dev.type == "cpu":
        return _bounded(window_hits_plain(dflat, nb_out, V, halo, L_blk, src,
                                          idx), max_hits)
    fields = window_fields(L_blk, src, idx)
    form = fields.pop("form")
    return _hits_two_pass("ac_window_hits", dev, fields["B"], max_hits, form,
                          table=dflat, nb_out=nb_out, L=L_blk, V=V,
                          halo=halo, **fields, **sub)
