"""K1 dense count, K2 dense states and K6 dense count_many: the 1-char
scans over the fail-collapsed table, each as a CUDA kernel
(csrc/dense_scan.cu) beside its plain PyTorch version.

Counterparts: K1 is ``ops/scan_pallas.py:make_pallas_blocked_count``, the
JAX package's only Pallas kernel, whose function is
``ops/scan_xla.py:blocked_count_core`` (``make_blocked_count_stream`` /
``_raw``); K2 is ``ops/scan_xla.py:make_blocked_scan_stream`` / ``_raw``,
and in two more modes ``make_sequential_scan`` (``sequential_states``, one
thread) and ``make_blocked_scan`` (``blocked_states``, a time-major batch);
K6 is ``ops/scan_xla.py:_count_many_body`` (``make_blocked_count_many``).

Every scan here reads a contiguous stream buffer ``ext`` of
``halo + B*L`` symbols, cut into B streams of L symbols; window row t of
stream b is ``ext[b*L + t]``. With a ``lut`` the symbols are raw (uint8
bytes or int32 codepoints) and translate to letter ids on the fly, with
stream 0's ``halo`` warm-up rows taken from ``head_ids``
(``ops/scan_xla.py:raw_window``). Without one, ``ext`` holds int32 letter
ids.

The count_many scans read a time-major batch ``tm`` [L, B] instead, one
document per column, each split into c blocks of Lp symbols
(``split_window``).

On the card every kernel here (and K8, ``ops/hits.py``) runs each stream
or batch column as P sub-streams, each warmed up over ``warm_steps``
symbols from the root before its body; the stream forms stage the 1-char
tables in shared memory where their real rows fit (``dense_fields``), the
batch forms read them in device memory (``batch_fields``). Their
wrappers require ``warm_steps``, which both scanners derive from the
tables (``multistep.warm_steps_for(tables, 1)``) in
``models/scanner.py:bind_scanner``.
K2's one-thread form is one chain from the root (P = 1) and takes none.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
device it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


def _check_inputs(syms: torch.Tensor, lut: Optional[torch.Tensor],
                  tables) -> torch.device:
    """Types, devices and contiguity of a scan's symbols and tables; return
    their common device."""
    dev = syms.device
    if lut is None:
        if syms.dtype != torch.int32:
            raise ValueError(f"letter-id input must be int32 "
                             f"(got {syms.dtype})")
    else:
        if syms.dtype not in (torch.uint8, torch.int32):
            raise ValueError(f"raw input must be uint8 or int32 "
                             f"(got {syms.dtype})")
        tables = tables + (lut,)
    for t in tables:
        if t.dtype != torch.int32:
            raise ValueError(f"tables must be int32 (got {t.dtype})")
    for t in (syms,) + tables:
        if t.device != dev:
            raise ValueError(f"inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_stream(B: int, L: int, halo: int, ext: torch.Tensor,
                 lut: Optional[torch.Tensor], head_ids: Optional[torch.Tensor],
                 *tables: torch.Tensor) -> torch.device:
    """Validate a stream scan's inputs; return their common device."""
    if ext.dim() != 1 or ext.numel() != halo + B * L:
        raise ValueError(f"ext must be 1-D with halo + B*L = {halo + B * L} "
                         f"symbols (got shape {tuple(ext.shape)})")
    if lut is not None:
        if head_ids is None or head_ids.numel() != halo:
            raise ValueError(f"raw input needs {halo} head_ids")
        tables = tables + (head_ids,)
    return _check_inputs(ext, lut, tables)


def check_batch(c: int, Lp: int, tm: torch.Tensor,
                lut: Optional[torch.Tensor], *tables: torch.Tensor
                ) -> torch.device:
    """Validate a count_many scan's inputs; return their common device."""
    if tm.dim() != 2 or c < 1 or tm.shape[0] > c * Lp:
        raise ValueError(f"tm must be [L, B] with L <= c*Lp = {c * Lp} "
                         f"(got shape {tuple(tm.shape)})")
    return _check_inputs(tm, lut, tables)


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


def split_window(c: int, Lp: int, halo: int, tm: torch.Tensor,
                 lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[halo + Lp, c*B] letter ids of a [L, B] batch: column i*B + j is
    block i of document j, rows i*Lp - halo .. (i+1)*Lp of it, id 0 before
    the document's head and past L — ``ops/scan_xla.py:split_docs_layout``,
    after the reference's LUT gather (``lut[tm]``)."""
    L, B = tm.shape
    ids = tm.long() if lut is None else lookup(lut, tm)
    padded = torch.zeros((halo + c * Lp, B), dtype=torch.int64,
                         device=tm.device)
    padded[halo:halo + L] = ids
    return padded.as_strided((halo + Lp, c, B), (B, Lp * B, 1)).reshape(
        halo + Lp, c * B)


def _count_window(dflat, nb_out, V: int, halo: int,
                  win: torch.Tensor) -> torch.Tensor:
    """int32 match totals per column of [halo + L, n] letter ids, rows
    past the halo (``ops/scan_xla.py:blocked_count_core``)."""
    s = torch.zeros(win.shape[1], dtype=torch.int64, device=win.device)
    tot = torch.zeros(win.shape[1], dtype=torch.int32, device=win.device)
    for t in range(win.shape[0]):
        s = dflat[s * V + win[t]].long()
        if t >= halo:
            tot += nb_out[s]
    return tot


def dense_count_plain(dflat, nb_out, V: int, halo: int, B: int, L: int,
                      ext, lut=None, head_ids=None) -> torch.Tensor:
    """Plain K1: per-stream int32 match totals [B] (rows past the halo)."""
    return _count_window(dflat, nb_out, V, halo,
                         window(B, L, halo, ext, lut, head_ids))


def dense_count_many_plain(dflat, nb_out, V: int, halo: int, c: int,
                           Lp: int, tm, lut=None) -> torch.Tensor:
    """Plain K6: int32 match totals per batch column [c*B]; column
    i*B + j holds block i of document j."""
    return _count_window(dflat, nb_out, V, halo,
                         split_window(c, Lp, halo, tm, lut))


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


def batch_fields(warm_steps: int, split: int) -> dict:
    """The launch fields of sub-streams over 1-char tables in device
    memory (K6, K2's time-major form): ``warm_steps``, the symbols each
    sub-stream reads from the root before its body (max_depth - 1 of the
    tables: ``multistep.warm_steps_for(tables, 1)``), and ``split``, the
    sub-streams per column (0: the launcher picks)."""
    if warm_steps < 0:
        raise ValueError(f"warm_steps={warm_steps} < 0")
    build.check_split(split)
    return dict(warm_steps=warm_steps, split=split)


def dense_fields(dflat, V: int, warm_steps: int, split: int,
                 n_states: Optional[int], global_table: bool) -> dict:
    """``batch_fields`` of the 1-char stream kernels (K1, K2, K7 dense,
    K8), whose tables go on the SM where they fit, with ``n_states``, the
    table rows that exist (all of dflat's rows when None; those the kernel
    stages on the SM), and ``global_table``, which keeps the tables in
    device memory even where they fit on the SM."""
    rows = dflat.numel() // V
    if n_states is not None:
        if not 0 < n_states <= rows:
            raise ValueError(f"n_states={n_states} outside (0, {rows}]")
        rows = n_states
    return dict(batch_fields(warm_steps, split), n_states=rows,
                global_table=int(global_table))


def dense_count(dflat, nb_out, V: int, halo: int, B: int, L: int, ext,
                lut=None, head_ids=None, *, warm_steps: int, split: int = 0,
                n_states: Optional[int] = None,
                global_table: bool = False) -> torch.Tensor:
    """K1: per-stream int32 match totals [B]; the caller sums them in
    int64. On the card each stream runs as ``split`` sub-streams
    (``dense_fields``)."""
    dev = check_stream(B, L, halo, ext, lut, head_ids, dflat, nb_out)
    sub = dense_fields(dflat, V, warm_steps, split, n_states, global_table)
    if dev.type == "cpu":
        return dense_count_plain(dflat, nb_out, V, halo, B, L, ext, lut,
                                 head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_dense_count", dev, table=dflat, nb_out=nb_out, ext=ext,
                 lut=lut, head_ids=head_ids, out=out, L=L, B=B, V=V,
                 halo=halo, ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), **sub)
    return out


def dense_states(dflat, V: int, halo: int, B: int, L: int, ext, lut=None,
                 head_ids=None, *, warm_steps: int, split: int = 0,
                 n_states: Optional[int] = None,
                 global_table: bool = False) -> torch.Tensor:
    """K2: int32 state after every body symbol, stream order [B*L]. On
    the card each stream runs as ``split`` sub-streams
    (``dense_fields``)."""
    dev = check_stream(B, L, halo, ext, lut, head_ids, dflat)
    sub = dense_fields(dflat, V, warm_steps, split, n_states, global_table)
    if dev.type == "cpu":
        return dense_states_plain(dflat, V, halo, B, L, ext, lut, head_ids)
    out = torch.empty(B * L, dtype=torch.int32, device=dev)
    build.launch("ac_dense_states", dev, table=dflat, ext=ext, lut=lut,
                 head_ids=head_ids, out=out, L=L, B=B, V=V, halo=halo,
                 ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), **sub)
    return out


def dense_count_many(dflat, nb_out, V: int, halo: int, c: int, Lp: int, tm,
                     lut=None, *, warm_steps: int,
                     split: int = 0) -> torch.Tensor:
    """K6: int32 match totals per batch column [c*B] of the time-major
    batch ``tm`` [L, B] (int32 ids, or raw uint8/int32 symbols with
    ``lut``) split into c blocks of Lp with a ``halo`` from the same
    document; the caller sums each document's c blocks in int64. On the
    card each column runs as ``split`` sub-streams (``batch_fields``)."""
    dev = check_batch(c, Lp, tm, lut, dflat, nb_out)
    sub = batch_fields(warm_steps, split)
    if dev.type == "cpu":
        return dense_count_many_plain(dflat, nb_out, V, halo, c, Lp, tm, lut)
    L, B = tm.shape
    out = torch.empty(c * B, dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    build.launch("ac_dense_count_many", dev, table=dflat, nb_out=nb_out,
                 ext=tm, lut=lut, out=out, L=Lp, B=c * B, V=V, halo=halo,
                 ext_u8=int(tm.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), doc_len=L,
                 n_docs=B, **sub)
    return out


def sequential_states_plain(dflat, V: int, ids) -> torch.Tensor:
    """Plain K2, one stream from the root: int32 state after each id."""
    return dense_states_plain(dflat, V, 0, 1, ids.numel(), ids)


def sequential_states(dflat, V: int, ids, *, n_states: Optional[int] = None,
                      global_table: bool = False) -> torch.Tensor:
    """K2 in one thread: int32 state after each of the int32 letter ids
    [T], the literal recurrence (``scan_states_sequential``): K2 with
    B = 1, no halo and one sub-stream, one chain from the root (no
    warm-up), counted as its form "seq"; its block stages the tables on
    the SM where ``n_states`` rows fit (``dense_fields``)."""
    T = ids.numel()
    dev = check_stream(1, T, 0, ids, None, None, dflat)
    sub = dense_fields(dflat, V, 0, 1, n_states, global_table)
    if dev.type == "cpu":
        return sequential_states_plain(dflat, V, ids)
    out = torch.empty(T, dtype=torch.int32, device=dev)
    if T:
        build.launch("ac_dense_states", dev, form="seq", table=dflat,
                     ext=ids, out=out, L=T, B=1, V=V, halo=0, **sub)
    return out


def blocked_states_plain(dflat, V: int, tm) -> torch.Tensor:
    """Plain K2 time-major: int32 states [L, B] of the columns of tm."""
    s = torch.zeros(tm.shape[1], dtype=torch.int64, device=tm.device)
    out = torch.empty(tm.shape, dtype=torch.int32, device=tm.device)
    for t in range(tm.shape[0]):
        s = dflat[s * V + tm[t].long()].long()
        out[t] = s
    return out


def blocked_states(dflat, V: int, tm, *, warm_steps: int,
                   split: int = 0) -> torch.Tensor:
    """K2 over a time-major [L, B] batch of int32 letter ids, every column
    from the root: int32 states [L, B]. On the card each column runs as
    ``split`` sub-streams (``batch_fields``)."""
    if tm.dim() != 2:
        raise ValueError(f"tm must be [L, B] (got shape {tuple(tm.shape)})")
    dev = _check_inputs(tm, None, (dflat,))
    sub = batch_fields(warm_steps, split)
    if dev.type == "cpu":
        return blocked_states_plain(dflat, V, tm)
    L, B = tm.shape
    out = torch.empty((L, B), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch("ac_dense_states_tm", dev, table=dflat, ext=tm, out=out,
                     L=L, B=B, V=V, halo=0, doc_len=L, n_docs=B, **sub)
    return out
