"""The sparse prefilter (filter-then-verify): the host filter and elision,
the device block filter, and K7, the window count, beside its plain
PyTorch version.

Exactness rests on the vocabulary's OOV contract: id 0 appears in no
keyword, so ``delta[s, 0]`` is the root for every state and the root never
emits. No match ends inside an all-OOV block of ``L_blk`` symbols, and the
state after one is the root. Only "live" blocks, those with a non-OOV id,
are scanned, each as one window of the halo-blocked scan: the ``halo``
symbols before it in the stream, then its ``L_blk`` symbols, warm-up rows
not counted (the argument of the JAX package's ``ops/sparse.py``).

Host half: ``live_blocks``, ``elide_windows``, ``raw_live_blocks`` and
``raw_elision_plan`` are the numpy functions of the JAX package's
``ops/sparse.py:49-153``, which cannot be imported without JAX.

Device half:

* ``block_filter`` and ``dev_idx`` (``make_block_filter``, ``_dev_idx``):
  a per-block ``amax > 0``, the live blocks first in stream order by a
  stable sort, and ``n_live``, in plain PyTorch (a reduce and a sort, not
  a recurrence); one 4-byte synchronisation.
* ``window_gather``: the plain layout of ``_window_gather``.
* K7 (csrc/sparse_scan.cu): ``sparse_count`` runs K1's sub-streams and
  ``sparse_count_stepped`` K3's recurrence over the windows
  (``make_sparse_count``, ``make_sparse_count_stepped`` and their ``_dev``
  forms, and the elided counts of ``models/scanner.py:_elided_count_core``).
* K10's window forms (csrc/mxu_scan.cu, ``ops/scan_mxu.py``):
  ``sparse_count_mxu`` runs the MXU engine over the windows
  (``make_sparse_count_mxu[_dev]`` and the elided count's
  ``scan_mxu.make_mxu_count_halo``).

A window source ``src`` is either the stream ``ext`` [halo + (nB+1)*L_blk]
int32 ids, head halo in front and one all-OOV spare block at the end,
with ``idx`` [cap] int32 block indices in [0, nB] (pad slots point at the
spare block nB): the index-list form; or host-elided windows [halo +
L_blk, n] int32, time-major (``elide_windows``): the elided form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .multistep import _count_grams
from .scan_dense import _check_inputs, _count_window, dense_fields
from .scan_mxu import check_planes, mxu_count_window, mxu_fields

# -- host half ---------------------------------------------------------------


def live_blocks(ids: np.ndarray, L_blk: int) -> np.ndarray:
    """Host filter pass: bool[ceil(T/L_blk)], block holds a non-OOV id.
    Letter ids are non-negative, so a row max is the exact test; the tail
    block is padded with OOV."""
    T = len(ids)
    nB = -(-T // L_blk)
    if nB * L_blk != T:
        ids = np.concatenate([ids, np.zeros(nB * L_blk - T, np.int32)])
    return ids.reshape(nB, L_blk).max(axis=1) != 0


def elide_windows(arr: np.ndarray, lut, T: int, live: np.ndarray,
                  n_live: int, head, halo: int, L_blk: int, nB_real: int,
                  pad_cols_to: int = 1):
    """Host dead-block elision: gather the live blocks' halo windows from
    the symbol array (no full-length staging buffer), translating raw
    symbols through the host LUT ``(lut_host, n_lut)``. Returns (tm, idx):
    the [halo + L_blk, cap] time-major int32 windows to upload (cap a pow2
    bucket of n_live, rounded up to ``pad_cols_to``) and the int64 [cap]
    block indices (pad columns point at the spare all-OOV block nB_real,
    whose positions land past the stream end). Out-of-range positions are
    OOV and block 0's halo is ``head`` (id-space session carry)."""
    cap = max(8, 1 << (n_live - 1).bit_length())
    cap = -(-cap // pad_cols_to) * pad_cols_to
    idx = np.full(cap, nB_real, np.int64)       # pad -> spare dead block
    idx[:n_live] = np.flatnonzero(live)
    cols = np.arange(-halo, L_blk, dtype=np.int64)
    pos = idx[:, None] * L_blk + cols[None, :]
    safe = np.clip(pos, 0, max(T - 1, 0))
    win = arr[safe]
    if lut is not None:
        lut_host, n_lut = lut
        if win.dtype == np.uint8 and n_lut >= 256:
            win = lut_host[win]
        else:
            win = lut_host[np.minimum(win.astype(np.int64, copy=False),
                                      n_lut - 1)]
    else:
        win = win.astype(np.int32, copy=False)
    win[(pos < 0) | (pos >= T)] = 0
    if halo:
        r0 = np.flatnonzero(idx == 0)
        if r0.size:
            hrow = np.zeros(halo, np.int32)
            if head is not None and len(head):
                hh = min(len(head), halo)
                hrow[halo - hh:] = np.asarray(head, np.int32)[-hh:]
            win[r0[0], :halo] = hrow
    return np.ascontiguousarray(win.T), idx


def raw_live_blocks(raw: np.ndarray, lut_host: np.ndarray, n_lut: int,
                    L_blk: int):
    """Live-block filter over raw symbols through the host LUT (live iff a
    symbol's id is non-OOV, the id-path test). Byte corpora take a uint8
    bool-LUT gather, one byte a symbol. Returns (live bool[nB], nB_real)."""
    T = len(raw)
    nB_real = -(-T // L_blk)
    if raw.dtype == np.uint8 and n_lut >= 256:
        lv = (lut_host != 0).astype(np.uint8)[raw]
    else:
        lv = (lut_host[np.minimum(raw.astype(np.int64, copy=False),
                                  n_lut - 1)] != 0).astype(np.uint8)
    pad = nB_real * L_blk - T
    if pad:
        lv = np.concatenate([lv, np.zeros(pad, np.uint8)])
    return lv.reshape(nB_real, L_blk).max(axis=1).astype(bool), nB_real


def raw_elision_plan(raw: np.ndarray, lut_host: np.ndarray, n_lut: int,
                     prefilter: str, halo: int, L_blk: int):
    """The elision decision over a raw input: (verdict, live, n_live,
    nB_real) with verdict "zero" (no live block: the count is 0), "dense"
    (the "auto" gate found over half the blocks live: take the dense raw
    kernels, do not re-filter), "na" (halo wider than a block, or live
    windows over half the stream: the id-path prefilter decides) or
    "elide" (upload only the live windows)."""
    if halo > L_blk:
        return "na", None, 0, 0
    live, nB_real = raw_live_blocks(raw, lut_host, n_lut, L_blk)
    n_live = int(live.sum())
    if n_live == 0:
        return "zero", live, 0, nB_real
    if prefilter == "auto" and n_live * 2 > nB_real:
        return "dense", live, n_live, nB_real
    if n_live * (halo + L_blk) * 2 >= max(len(raw), 1):
        return "na", live, n_live, nB_real
    return "elide", live, n_live, nB_real


# -- device half -------------------------------------------------------------


def block_filter(ext: torch.Tensor, nB: int, L_blk: int,
                 halo: int) -> Tuple[torch.Tensor, int]:
    """Live-block filter on the device over ext [halo + (nB+1)*L_blk]:
    (order int32 [nB], live block indices first in stream order, dead ones
    after; n_live). Syncs only the 4-byte live count."""
    body = ext[halo:halo + nB * L_blk].view(nB, L_blk)
    live = body.amax(dim=1) > 0
    n_live = int(live.sum())
    order = torch.argsort((~live).to(torch.uint8), stable=True)
    return order.to(torch.int32), n_live


def dev_idx(order: torch.Tensor, n_live: int, nB: int,
            cap: int) -> torch.Tensor:
    """int32 [cap]: the first cap entries of ``order``, the spare block nB
    past the live count."""
    lanes = torch.arange(cap, device=order.device)
    return torch.where(lanes < n_live, order[:cap],
                       torch.full_like(order[:cap], nB))


def window_gather(src: torch.Tensor, idx: Optional[torch.Tensor],
                  L_blk: int, halo: int) -> torch.Tensor:
    """[halo + L_blk, n] int64 letter ids of the windows, the plain
    versions' layout: column c, row t is ext[idx[c]*L_blk + t] (index-list
    form) or the elided windows themselves."""
    if src.dim() == 2:
        return src.long()
    rows = torch.arange(halo + L_blk, device=src.device)
    return src[idx.long()[None, :] * L_blk + rows[:, None]].long()


def check_windows(L_blk: int, halo: int, src: torch.Tensor,
                  idx: Optional[torch.Tensor], *tables: torch.Tensor
                  ) -> torch.device:
    """Validate a window source; return the common device."""
    if src.dim() == 1:
        if idx is None:
            raise ValueError("the index-list form needs idx")
        if src.numel() < halo + L_blk or (src.numel() - halo) % L_blk:
            raise ValueError(f"ext must hold halo + n*L_blk symbols "
                             f"(got {src.numel()})")
    elif src.dim() != 2 or src.shape[0] != halo + L_blk:
        raise ValueError(f"windows must be [halo + L_blk, n] = "
                         f"[{halo + L_blk}, n] (got {tuple(src.shape)})")
    if idx is not None:
        if idx.dim() != 1:
            raise ValueError("idx must be 1-D")
        tables = tables + (idx,)
    return _check_inputs(src, None, tables)


def window_fields(L_blk: int, src: torch.Tensor,
                  idx: Optional[torch.Tensor]) -> dict:
    """The launch fields of a window source, and its form's name."""
    if src.dim() == 1:
        return dict(ext=src, idx=idx, B=idx.numel(), gather=1,
                    col_stride=L_blk, row_stride=1, form="idx")
    n = src.shape[1]
    return dict(ext=src, idx=idx, B=n, gather=0, col_stride=1, row_stride=n,
                form="elided")


def _n_windows(src, idx) -> int:
    return idx.numel() if src.dim() == 1 else src.shape[1]


def sparse_count_plain(dflat, nb_out, V: int, halo: int, L_blk: int, src,
                       idx=None) -> torch.Tensor:
    """Plain K7 dense: int32 match totals per window (rows past the
    halo)."""
    return _count_window(dflat, nb_out, V, halo,
                         window_gather(src, idx, L_blk, halo))


def sparse_count(dflat, nb_out, V: int, halo: int, L_blk: int, src,
                 idx=None, *, warm_steps: int, split: int = 0,
                 n_states: Optional[int] = None,
                 global_table: bool = False) -> torch.Tensor:
    """K7 dense: int32 match totals per window [n]; the caller sums them in
    int64. On the card each window runs as ``split`` sub-streams, K1's
    (``scan_dense.dense_fields``: ``warm_steps``, max_depth - 1 symbols of
    the tables, is required)."""
    dev = check_windows(L_blk, halo, src, idx, dflat, nb_out)
    sub = dense_fields(dflat, V, warm_steps, split, n_states, global_table)
    if dev.type == "cpu":
        return sparse_count_plain(dflat, nb_out, V, halo, L_blk, src, idx)
    out = torch.empty(_n_windows(src, idx), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch("ac_sparse_count", dev, table=dflat, nb_out=nb_out,
                     out=out, L=L_blk, V=V, halo=halo,
                     **window_fields(L_blk, src, idx), **sub)
    return out


def sparse_count_stepped_plain(packed, V: int, k: int, count_bits: int,
                               halo_steps: int, L_blk: int, src,
                               idx=None) -> torch.Tensor:
    """Plain K7 stepped: int32 match totals per window past the halo
    grams."""
    return _count_grams(packed, V, k, count_bits, halo_steps,
                        window_gather(src, idx, L_blk, halo_steps * k))


def sparse_count_stepped(packed, V: int, k: int, count_bits: int,
                         halo_steps: int, L_blk: int, src,
                         idx=None) -> torch.Tensor:
    """K7 stepped: int32 match totals per window [n] through the packed
    k-gram table; L_blk is a multiple of k."""
    if L_blk % k:
        raise ValueError(f"L_blk={L_blk} is not a multiple of k={k}")
    halo = halo_steps * k
    dev = check_windows(L_blk, halo, src, idx, packed)
    if dev.type == "cpu":
        return sparse_count_stepped_plain(packed, V, k, count_bits,
                                          halo_steps, L_blk, src, idx)
    out = torch.empty(_n_windows(src, idx), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch("ac_sparse_count_stepped", dev, table=packed, out=out,
                     L=L_blk, Vk=V ** k, V=V, halo=halo, k=k,
                     count_bits=count_bits,
                     **window_fields(L_blk, src, idx))
    return out


def sparse_count_mxu_plain(planes, V: int, count_bits: int, n_planes: int,
                           halo: int, L_blk: int, src,
                           idx=None) -> torch.Tensor:
    """Plain K10 window forms: int32 match totals per window (rows past
    the halo) through the MXU engine."""
    return mxu_count_window(planes, V, count_bits, n_planes, halo,
                            window_gather(src, idx, L_blk, halo))


def sparse_count_mxu(planes, V: int, count_bits: int, n_planes: int,
                     halo: int, L_blk: int, src, idx=None, *,
                     planes_t: torch.Tensor) -> torch.Tensor:
    """K10 window forms: int32 match totals per window [n] through the
    MXU engine, over the index list ("idx") or host-elided windows
    ("elided"); the caller sums them in int64."""
    check_planes(planes, V, n_planes)
    dev = check_windows(L_blk, halo, src, idx)
    if planes.device != dev:
        raise ValueError(f"inputs on {planes.device} and {dev}")
    fields = mxu_fields(planes, V, count_bits, n_planes, planes_t)
    if dev.type == "cpu":
        return sparse_count_mxu_plain(planes, V, count_bits, n_planes, halo,
                                      L_blk, src, idx)
    out = torch.empty(_n_windows(src, idx), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch("ac_mxu_count", dev, out=out, L=L_blk, halo=halo,
                     layout=2, **window_fields(L_blk, src, idx), **fields)
    return out
