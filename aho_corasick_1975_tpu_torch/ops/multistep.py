"""k-char stepped scan tables, K3 the packed k-gram count, K5 its
count_many form and K9 the two-table count.

Tables: ``choose_k`` and ``stepped_delta_cells`` are the numpy functions
of the JAX package's ``ops/multistep.py``, which cannot be imported
without JAX: the choice of k, and the cells an online insertion changes
(refresh). A snapshot composes its k-gram table on its own device from the
uploaded 1-char tables, in torch ops (``max_gram_count``,
``packed_count_bits``, ``compose_packed``, ``compose_two_tables``): the
packed table ``(next_state << count_bits) | gram_count``, so that one
gather advances k symbols and counts every match inside them, or, where
(state, count) need more than 31 bits, the two tables ``delta_k`` and
``cnt_k``, entry for entry the JAX package's ``build_stepped``.

Device half: K3 (csrc/stepped_scan.cu) is the count of
``ops/multistep.py:stepped_count_core`` (``make_stepped_count_stream`` /
``_raw``), K5 the same count over a split ``[L, B]`` batch
(``_stepped_count_many_body``), and K9 the count over the two tables
(``make_stepped_count_unpacked_stream`` and, for count_many's time-major
batch, ``make_stepped_count_unpacked``), each beside its plain PyTorch
version. Inputs follow ``ops/scan_dense.py``, with
``halo = halo_steps * k`` and ``L % k == 0``. On the card K3, K5 and K9
split every stream or column into sub-streams that each warm up over
``warm_steps`` grams before their body (``split_fields``); every card-path
wrapper requires ``warm_steps``, which both scanners derive from the
tables (``warm_steps_for``) in ``models/scanner.py:bind_scanner``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.builder import round_cap
from . import build
from .scan_dense import (_check_inputs, check_batch, check_stream,
                         split_window, window)


@dataclass
class SteppedTables:
    """A snapshot's record of its k-gram table, whose tensors it holds."""
    k: int                      # symbols per gather
    V: int                      # base vocab size
    count_bits: int             # 0 in the two-table form

    @property
    def Vk(self) -> int:
        return self.V ** self.k


def choose_k(n_states: int, vocab_size: int, budget_bytes: int,
             max_k: int = 4) -> int:
    """Largest k with S * V^k * 4 bytes within budget."""
    k = 1
    for cand in range(2, max_k + 1):
        if n_states * (vocab_size ** cand) * 4 <= budget_bytes:
            k = cand
    return k


def stepped_delta_cells(old, new, k: int):
    """Exact changed-cell set of the k-gram stepped table between two
    snapshots of one machine (``ops/multistep.py:stepped_delta_cells``,
    where the derivation is). dirty_1 marks the (state, letter) cells whose
    hop or landing count changed; dirty_{j+1}[m, c.g] = dirty_1[m, c] |
    dirty_j[delta[m, c], g]; the top level is enumerated sparsely, so the
    cost is O(S*V + output cells).

    Returns (cells, land, cnt): flat int32 indices into the [S_new * V^k]
    table, the recomputed landing states (int32) and the recomputed k-gram
    counts (int64)."""
    assert k >= 1
    S_old = old.n_states
    delta, nb = new.delta, new.nb_outputs
    S_new, V = delta.shape
    dirty1 = np.ones((S_new, V), dtype=bool)
    np.not_equal(old.delta, delta[:S_old], out=dirty1[:S_old])
    nbD = np.ones(S_new, dtype=bool)
    np.not_equal(old.nb_outputs, nb[:S_old], out=nbD[:S_old])
    dirty1 |= nbD[delta]
    if k == 1:
        sp, cp = np.nonzero(dirty1)
        cells = (sp.astype(np.int64) * V + cp).astype(np.int32)
        land = delta[sp, cp].astype(np.int32)
        return cells, land, nb[land].astype(np.int64)
    dirty = dirty1
    for _ in range(k - 2):
        G = dirty.shape[1]
        dirty = (dirty1[:, :, None] | dirty[delta]).reshape(S_new, V * G)
    G = dirty.shape[1]
    Vk = V * G

    # sparse top level: per (state, first letter) pair, all G tails when
    # its own hop is dirty, else the landing state's changed tails
    t_cnt = dirty.sum(axis=1, dtype=np.int64)
    sp, cp = np.nonzero(dirty1 | (t_cnt[delta] > 0))
    if not len(sp):
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0, np.int64)
    mp = delta[sp, cp]
    full = dirty1[sp, cp]
    cnts = np.where(full, G, t_cnt[mp])
    offs = np.cumsum(cnts) - cnts
    tails_out = np.empty(int(cnts.sum()), np.int64)
    fi = np.flatnonzero(full)
    if len(fi):
        idx = (offs[fi][:, None] + np.arange(G, dtype=np.int64)).reshape(-1)
        tails_out[idx] = np.tile(np.arange(G, dtype=np.int64), len(fi))
    si = np.flatnonzero(~full & (cnts > 0))
    if len(si):
        # CSR over the changed-tail lists of the dirty states
        changed_states = np.flatnonzero(t_cnt > 0)
        _, tails_vals = np.nonzero(dirty[changed_states])
        tails_start = np.concatenate(
            [[0], np.cumsum(t_cnt[changed_states])])[:-1]
        inv = np.full(S_new, -1, np.int64)
        inv[changed_states] = np.arange(len(changed_states))
        lens = cnts[si]
        src0 = tails_start[inv[mp[si]]]
        inner = (np.arange(int(lens.sum()), dtype=np.int64)
                 - np.repeat(np.cumsum(lens) - lens, lens))
        tails_out[np.repeat(offs[si], lens) + inner] = \
            tails_vals[np.repeat(src0, lens) + inner]
    srep = np.repeat(sp.astype(np.int64), cnts)
    grep = np.repeat(cp.astype(np.int64), cnts) * G + tails_out
    cells = (srep * Vk + grep).astype(np.int32)

    # recompute the cells' values by walking the gram's letters
    m = srep
    cnt = np.zeros(len(srep), np.int64)
    for i in range(k):
        m = delta[m, grep // (V ** (k - 1 - i)) % V]
        cnt += nb[m]
    return cells, m.astype(np.int32), cnt


# A snapshot's k-gram table, composed on its device from the uploaded 1-char
# tables: the JAX package's build_stepped DP and entries, in torch ops. Row
# blocks keep each [rows, V^k] temporary, at 8 bytes an entry, within this
# size.
COMPOSE_BLOCK_BYTES = 1 << 30


def _row_blocks(S: int, Vk: int):
    step = max(1, COMPOSE_BLOCK_BYTES // (8 * Vk))
    return [(r, min(r + step, S)) for r in range(0, S, step)]


def packed_count_bits(max_cnt: int, S: int) -> Optional[int]:
    """``count_bits`` of the packed entry ``(state << count_bits) | count``
    for S states whose k-gram counts reach ``max_cnt``, with the JAX
    package's headroom for in-place refresh (so that both packages build
    bit-identical tables); None where the entry needs more than 31 bits
    (the two-table form)."""
    count_bits = max(1, int(max_cnt).bit_length()) if max_cnt else 1
    state_bits = max(1, int(S - 1).bit_length())
    grow_bits = max(1, int(round_cap(S) - 1).bit_length())
    count_bits = max(count_bits,
                     min(count_bits + 3, 31 - max(state_bits, grow_bits)))
    return count_bits if state_bits + count_bits <= 31 else None


def max_gram_count(delta: torch.Tensor, nb: torch.Tensor, S: int,
                   k: int) -> int:
    """The largest k-gram match count from the first S rows of ``delta``
    [>= S, V] and ``nb`` (int32 tensors on one device), by build_stepped's
    DP in int64: h_j[m] = max_c (nb + h_{j-1})[delta[m, c]], h_0 = 0. One
    host sync."""
    if not S:
        return 0
    nb64 = nb[:S].long()
    h = torch.zeros(S, dtype=torch.int64, device=delta.device)
    for _ in range(k):
        g, h = nb64 + h, torch.empty_like(h)
        for r0, r1 in _row_blocks(S, delta.shape[1]):
            h[r0:r1] = g.index_select(0, delta[r0:r1].reshape(-1)).view(
                r1 - r0, -1).amax(dim=1)
    return int(h.max())


def _gram_blocks(delta: torch.Tensor, nb: torch.Tensor, S: int, k: int):
    """Each row block's (first row, last row + 1, landing states, counts)
    of the k-gram table of the first S rows of ``delta`` [>= S, V] and
    ``nb``: int32 [(r1 - r0) * V^k] each, in the JAX package's
    ``compose_rows`` order of grams."""
    V = delta.shape[1]
    nb = nb[:S]
    for r0, r1 in _row_blocks(S, V ** k):
        d = delta[r0:r1].reshape(-1)
        cnt = nb.index_select(0, d)
        for _ in range(k - 1):
            d = delta.index_select(0, d).reshape(-1)
            cnt = (cnt.view(-1, 1)
                   + nb.index_select(0, d).view(-1, V)).reshape(-1)
        yield r0, r1, d, cnt


def compose_packed(delta: torch.Tensor, nb: torch.Tensor, S: int, k: int,
                   count_bits: int, rows: int) -> torch.Tensor:
    """The packed k-gram table of the first S rows of ``delta`` [>= S, V]
    and ``nb`` on their device: int32 [rows * V^k], rows S.. zero, entry
    for entry build_stepped's. In int32 throughout: ``count_bits`` from
    ``packed_count_bits`` bounds every entry, and every partial count (a
    gram's prefix counts no more than the gram), below 2^31."""
    Vk = delta.shape[1] ** k
    out = torch.zeros(rows * Vk, dtype=torch.int32, device=delta.device)
    for r0, r1, d, cnt in _gram_blocks(delta, nb, S, k):
        torch.bitwise_or(d << count_bits, cnt, out=out[r0 * Vk:r1 * Vk])
    return out


def compose_two_tables(delta: torch.Tensor, nb: torch.Tensor, S: int,
                       k: int, rows: int) -> tuple:
    """The two-table form of ``compose_packed``'s table: (``delta_k``,
    ``cnt_k``), int32 [rows * V^k] each, rows S.. zero, entry for entry
    build_stepped's unpacked tables (whose int64 counts it casts to int32
    as this sums them)."""
    Vk = delta.shape[1] ** k
    land, cnt_k = (torch.zeros(rows * Vk, dtype=torch.int32,
                               device=delta.device) for _ in range(2))
    for r0, r1, d, cnt in _gram_blocks(delta, nb, S, k):
        land[r0 * Vk:r1 * Vk] = d
        cnt_k[r0 * Vk:r1 * Vk] = cnt
    return land, cnt_k


def combine_grams(win: torch.Tensor, V: int, k: int) -> torch.Tensor:
    """[rows, B] letter ids -> [rows/k, B] k-gram ids (rows % k == 0)."""
    g = win[0::k]
    for j in range(1, k):
        g = g * V + win[j::k]
    return g


def check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids):
    if L % k:
        raise ValueError(f"L={L} is not a multiple of k={k}")
    return check_stream(B, L, halo_steps * k, ext, lut, head_ids, packed)


def split_fields(V: int, k: int, warm_steps: int, split: int) -> dict:
    """The launch fields of a stepped launch's sub-streams (K3-K5, K9,
    K11's gather half): ``warm_steps``, the grams each sub-stream reads
    from the root before its body, ``ceil((max_depth - 1) / k)`` of the
    tables (``warm_steps_for``; K4's ``emit_warm_steps_for``,
    ``ceil(max_depth / k)``), and ``split``, the sub-streams per
    column (0: the launcher picks). The kernels combine a gram in 32 bits,
    as the reference does in int32."""
    if warm_steps < 0:
        raise ValueError(f"warm_steps={warm_steps} < 0")
    if V ** k >= 2 ** 31:
        raise ValueError(f"V^k = {V ** k} grams do not fit int32")
    build.check_split(split)
    return dict(warm_steps=warm_steps, split=split)


def warm_steps_for(tables, k: int) -> int:
    """Grams of warm-up that put a sub-stream's state right from its
    body's first symbol on: max_depth - 1 symbols, in grams of k."""
    return -(-max(tables.max_depth - 1, 0) // k)


def emit_warm_steps_for(tables, k: int) -> int:
    """K4's warm-up: grams that put a sub-stream's state right before its
    body's first symbol too (the pre-state of its first gram, which may be
    the end of a longest keyword, max_depth deep): max_depth symbols, one
    more than ``warm_steps_for``'s, in grams of k."""
    return -(-tables.max_depth // k)


def _count_grams(packed, V: int, k: int, count_bits: int, halo_steps: int,
                 win: torch.Tensor) -> torch.Tensor:
    """int32 match totals per column of [rows, n] letter ids (rows % k ==
    0), grams past the halo (``ops/multistep.py:stepped_count_core``)."""
    grams = combine_grams(win, V, k)
    mask, Vk = (1 << count_bits) - 1, V ** k
    s = torch.zeros(win.shape[1], dtype=torch.int64, device=win.device)
    tot = torch.zeros(win.shape[1], dtype=torch.int32, device=win.device)
    for j in range(grams.shape[0]):
        v = packed[s * Vk + grams[j]]
        s = (v >> count_bits).long()
        if j >= halo_steps:
            tot += v & mask
    return tot


def _count_grams_2t(delta_k, cnt_k, V: int, k: int, halo_steps: int,
                    win: torch.Tensor) -> torch.Tensor:
    """``_count_grams`` over the two tables
    (``ops/multistep.py:make_stepped_count_unpacked``)."""
    grams = combine_grams(win, V, k)
    Vk = V ** k
    s = torch.zeros(win.shape[1], dtype=torch.int64, device=win.device)
    tot = torch.zeros(win.shape[1], dtype=torch.int32, device=win.device)
    for j in range(grams.shape[0]):
        i = s * Vk + grams[j]
        s = delta_k[i].long()
        if j >= halo_steps:
            tot += cnt_k[i]
    return tot


def stepped_count_plain(packed, V: int, k: int, count_bits: int,
                        halo_steps: int, B: int, L: int, ext, lut=None,
                        head_ids=None) -> torch.Tensor:
    """Plain K3: per-stream int32 match totals [B] past the halo grams."""
    return _count_grams(packed, V, k, count_bits, halo_steps,
                        window(B, L, halo_steps * k, ext, lut, head_ids))


def check_stepped_many(packed, k, c, Lp, tm, lut):
    if Lp % k or tm.dim() != 2 or tm.shape[0] % k:
        raise ValueError(f"Lp={Lp} and L (tm {tuple(tm.shape)}) must be "
                         f"multiples of k={k}")
    return check_batch(c, Lp, tm, lut, packed)


def stepped_count_many_plain(packed, V: int, k: int, count_bits: int,
                             halo_steps: int, c: int, Lp: int, tm,
                             lut=None) -> torch.Tensor:
    """Plain K5: int32 match totals per batch column [c*B]; column i*B + j
    holds block i of document j (``ops/scan_dense.py:split_window``)."""
    return _count_grams(packed, V, k, count_bits, halo_steps,
                        split_window(c, Lp, halo_steps * k, tm, lut))


def stepped_count(packed, V: int, k: int, count_bits: int, halo_steps: int,
                  B: int, L: int, ext, lut=None, head_ids=None, *,
                  warm_steps: int, split: int = 0) -> torch.Tensor:
    """K3: per-stream int32 match totals [B]; the caller sums them in
    int64. On the card each stream runs as ``split`` sub-streams
    (``split_fields``)."""
    dev = check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids)
    sub = split_fields(V, k, warm_steps, split)
    if dev.type == "cpu":
        return stepped_count_plain(packed, V, k, count_bits, halo_steps, B,
                                   L, ext, lut, head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_stepped_count", dev, table=packed, ext=ext, lut=lut,
                 head_ids=head_ids, out=out, L=L, Vk=V ** k, B=B, V=V,
                 halo=halo_steps * k, ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k,
                 count_bits=count_bits, **sub)
    return out


def stepped_count_many(packed, V: int, k: int, count_bits: int,
                       halo_steps: int, c: int, Lp: int, tm,
                       lut=None, *, warm_steps: int,
                       split: int = 0) -> torch.Tensor:
    """K5: int32 match totals per batch column [c*B] of the time-major
    batch ``tm`` [L, B] (int32 ids, or raw uint8/int32 symbols with
    ``lut``) split into c blocks of Lp with ``halo_steps`` grams of halo
    from the same document; the caller sums each document's c blocks in
    int64. L and Lp are multiples of k. On the card each column runs as
    ``split`` sub-streams (``split_fields``)."""
    dev = check_stepped_many(packed, k, c, Lp, tm, lut)
    sub = split_fields(V, k, warm_steps, split)
    if dev.type == "cpu":
        return stepped_count_many_plain(packed, V, k, count_bits, halo_steps,
                                        c, Lp, tm, lut)
    L, B = tm.shape
    out = torch.empty(c * B, dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    build.launch("ac_stepped_count_many", dev, table=packed, ext=tm, lut=lut,
                 out=out, L=Lp, Vk=V ** k, B=c * B, V=V,
                 halo=halo_steps * k, ext_u8=int(tm.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k,
                 count_bits=count_bits, doc_len=L, n_docs=B, **sub)
    return out


def stepped_count_2t_plain(delta_k, cnt_k, V: int, k: int, halo_steps: int,
                           B: int, L: int, ext, lut=None,
                           head_ids=None) -> torch.Tensor:
    """Plain K9: per-stream int32 match totals [B] past the halo grams."""
    return _count_grams_2t(delta_k, cnt_k, V, k, halo_steps,
                           window(B, L, halo_steps * k, ext, lut, head_ids))


def stepped_count_2t(delta_k, cnt_k, V: int, k: int, halo_steps: int, B: int,
                     L: int, ext, lut=None, head_ids=None, *,
                     warm_steps: int, split: int = 0) -> torch.Tensor:
    """K9: per-stream int32 match totals [B] through the two tables; the
    caller sums them in int64. Forms "ids" and "raw"; sub-streams as
    K3's."""
    dev = check_stepped(delta_k, k, halo_steps, B, L, ext, lut, head_ids)
    _check_inputs(ext, lut, (cnt_k,))
    sub = split_fields(V, k, warm_steps, split)
    if dev.type == "cpu":
        return stepped_count_2t_plain(delta_k, cnt_k, V, k, halo_steps, B, L,
                                      ext, lut, head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_stepped_count_2t", dev,
                 form="ids" if lut is None else "raw", table=delta_k,
                 table2=cnt_k, ext=ext, lut=lut, head_ids=head_ids, out=out,
                 L=L, Vk=V ** k, B=B, V=V, halo=halo_steps * k,
                 ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k, **sub)
    return out


def stepped_count_many_2t_plain(delta_k, cnt_k, V: int, k: int,
                                tm) -> torch.Tensor:
    """Plain K9 batch form: int32 match totals per column of the
    time-major batch ``tm`` [L, B], every column from the root."""
    return _count_grams_2t(delta_k, cnt_k, V, k, 0, tm.long())


def stepped_count_many_2t(delta_k, cnt_k, V: int, k: int, tm, *,
                          warm_steps: int, split: int = 0) -> torch.Tensor:
    """K9 batch form (count_many on the two tables, as the JAX scanner
    runs ``make_stepped_count_unpacked`` with no halo and no split): int32
    match totals [B] of the time-major batch ``tm`` [L, B] of int32 letter
    ids, L a multiple of k; the caller sums them in int64. On the card
    each column runs as ``split`` sub-streams, as K5's."""
    dev = check_stepped_many(delta_k, k, 1, tm.shape[0], tm, None)
    _check_inputs(tm, None, (cnt_k,))
    sub = split_fields(V, k, warm_steps, split)
    if dev.type == "cpu":
        return stepped_count_many_2t_plain(delta_k, cnt_k, V, k, tm)
    L, B = tm.shape
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    build.launch("ac_stepped_count_2t", dev, form="batch", table=delta_k,
                 table2=cnt_k, ext=tm, out=out, L=L, Vk=V ** k, B=B, V=V,
                 halo=0, k=k, doc_len=L, n_docs=B, layout=1, **sub)
    return out
