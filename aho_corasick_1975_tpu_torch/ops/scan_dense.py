"""K1 dense count and K2 dense states: the 1-char scans over the
fail-collapsed table, each as a CUDA kernel (csrc/dense_scan.cu) beside its
plain PyTorch version.

Counterparts: K1 is ``ops/scan_pallas.py:make_pallas_blocked_count``, the
JAX package's only Pallas kernel, whose function is
``ops/scan_xla.py:blocked_count_core`` (``make_blocked_count_stream`` /
``_raw``); K2 is ``ops/scan_xla.py:make_blocked_scan_stream`` / ``_raw``.

Every scan here reads a contiguous stream buffer ``ext`` of
``halo + B*L`` symbols, cut into B streams of L symbols; window row t of
stream b is ``ext[b*L + t]``. With a ``lut`` the symbols are raw (uint8
bytes or int32 codepoints) and translate to letter ids on the fly, with
stream 0's ``halo`` warm-up rows taken from ``head_ids``
(``ops/scan_xla.py:raw_window``). Without one, ``ext`` holds int32 letter
ids.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
device it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


def check_stream(B: int, L: int, halo: int, ext: torch.Tensor,
                 lut: Optional[torch.Tensor], head_ids: Optional[torch.Tensor],
                 *tables: torch.Tensor) -> torch.device:
    """Validate a scan's inputs; return their common device."""
    dev = ext.device
    if ext.dim() != 1 or ext.numel() != halo + B * L:
        raise ValueError(f"ext must be 1-D with halo + B*L = {halo + B * L} "
                         f"symbols (got shape {tuple(ext.shape)})")
    if lut is None:
        if ext.dtype != torch.int32:
            raise ValueError(f"letter-id ext must be int32 (got {ext.dtype})")
    else:
        if ext.dtype not in (torch.uint8, torch.int32):
            raise ValueError(f"raw ext must be uint8 or int32 "
                             f"(got {ext.dtype})")
        if head_ids is None or head_ids.numel() != halo:
            raise ValueError(f"raw input needs {halo} head_ids")
        tables = tables + (lut, head_ids)
    for t in tables:
        if t.dtype != torch.int32:
            raise ValueError(f"tables must be int32 (got {t.dtype})")
    for t in (ext,) + tables:
        if t.device != dev:
            raise ValueError(f"inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def lookup(lut: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """int64 letter ids of raw symbols. A raw symbol indexes the LUT as an
    unsigned 32-bit value clamped to the last entry, as the kernels do
    (XLA's gather clamps)."""
    return lut.long()[(raw.long() & 0xFFFFFFFF).clamp_(max=lut.numel() - 1)]


def window(B: int, L: int, halo: int, ext: torch.Tensor,
           lut: Optional[torch.Tensor] = None,
           head_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[halo + L, B] letter ids, windows[t, b] = id of ext[b*L + t] — the
    plain versions' layout (``ops/scan_xla.py:window_layout`` and
    ``raw_window``)."""
    win = ext.as_strided((halo + L, B), (1, L))
    if lut is None:
        return win.long()
    win = lookup(lut, win)
    if halo:
        win[:halo, 0] = head_ids.long()
    return win


def dense_count_plain(dflat, nb_out, V: int, halo: int, B: int, L: int,
                      ext, lut=None, head_ids=None) -> torch.Tensor:
    """Plain K1: per-stream int32 match totals [B] (rows past the halo)."""
    win = window(B, L, halo, ext, lut, head_ids)
    s = torch.zeros(B, dtype=torch.int64, device=ext.device)
    tot = torch.zeros(B, dtype=torch.int32, device=ext.device)
    for t in range(halo + L):
        s = dflat[s * V + win[t]].long()
        if t >= halo:
            tot += nb_out[s]
    return tot


def dense_states_plain(dflat, V: int, halo: int, B: int, L: int, ext,
                       lut=None, head_ids=None) -> torch.Tensor:
    """Plain K2: int32 state after every body symbol, stream order
    [B*L]."""
    win = window(B, L, halo, ext, lut, head_ids)
    s = torch.zeros(B, dtype=torch.int64, device=ext.device)
    rows = []
    for t in range(halo + L):
        s = dflat[s * V + win[t]].long()
        if t >= halo:
            rows.append(s)
    if not rows:
        return torch.zeros(0, dtype=torch.int32, device=ext.device)
    return torch.stack(rows, dim=1).to(torch.int32).reshape(-1)


def dense_count(dflat, nb_out, V: int, halo: int, B: int, L: int, ext,
                lut=None, head_ids=None) -> torch.Tensor:
    """K1: per-stream int32 match totals [B]; the caller sums them in
    int64."""
    dev = check_stream(B, L, halo, ext, lut, head_ids, dflat, nb_out)
    if dev.type == "cpu":
        return dense_count_plain(dflat, nb_out, V, halo, B, L, ext, lut,
                                 head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_dense_count", dev, table=dflat, nb_out=nb_out, ext=ext,
                 lut=lut, head_ids=head_ids, out=out, L=L, B=B, V=V,
                 halo=halo, ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel())
    return out


def dense_states(dflat, V: int, halo: int, B: int, L: int, ext, lut=None,
                 head_ids=None) -> torch.Tensor:
    """K2: int32 state after every body symbol, stream order [B*L]."""
    dev = check_stream(B, L, halo, ext, lut, head_ids, dflat)
    if dev.type == "cpu":
        return dense_states_plain(dflat, V, halo, B, L, ext, lut, head_ids)
    out = torch.empty(B * L, dtype=torch.int32, device=dev)
    build.launch("ac_dense_states", dev, table=dflat, ext=ext, lut=lut,
                 head_ids=head_ids, out=out, L=L, B=B, V=V, halo=halo,
                 ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel())
    return out
