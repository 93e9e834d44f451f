"""k-char stepped scan tables, K3 the packed k-gram count, K5 its
count_many form and K9 the two-table count.

Tables: ``choose_k`` is the JAX package's choice of k (its
``ops/multistep.py`` cannot be imported without JAX). A snapshot composes
its k-gram table on its own device from the uploaded 1-char tables, in
torch ops (``max_gram_count``, ``packed_count_bits``, ``compose_packed``,
``compose_two_tables``): the packed table ``(next_state << count_bits) |
gram_count``, so that one gather advances k symbols and counts every match
inside them, or, where (state, count) need more than 31 bits, the two
tables ``delta_k`` and ``cnt_k``, entry for entry the JAX package's
``build_stepped``. An in-place refresh finds the rows and cells an online
insertion changes on the same device (``GramDelta``: the JAX package's row
diff and ``stepped_delta_cells``).

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


class GramDelta:
    """What an in-place refresh writes, found on the tables' device: the
    rows of the 1-char tables that differ between two versions of one
    machine, and the cells of the k-gram table that they change, with the
    cells' new landing states and counts. The row diff of the JAX
    package's ``models/snapshot.py:DeviceSnapshot.refresh`` and its
    ``ops/multistep.py:stepped_delta_cells``, where the derivation is:
    dirty_1 marks the (state, letter) cells whose hop or landing count
    changed, dirty_{j+1}[m, c.g] = dirty_1[m, c] | dirty_j[delta[m, c], g],
    and the top level, here a dense mask in ``_row_blocks``, gives the same
    cells in the same ascending order.

    ``d_old`` [S_old, V] and ``nb_old`` [S_old] are the old version's
    tables, ``d_new`` [S_new, V] and ``nb_new`` [S_new] the new one's
    (int32, one device, S_new >= S_old); ``k`` the k-gram table's, None
    where there is none (rows only). Construction enqueues the masks and
    their sizes; ``sizes()`` reads them in one sync; ``rows()`` and
    ``cells()`` then enumerate them without another."""

    def __init__(self, d_old: torch.Tensor, nb_old: torch.Tensor,
                 d_new: torch.Tensor, nb_new: torch.Tensor,
                 k: Optional[int]):
        S_old = d_old.shape[0]
        S, V = d_new.shape
        self.d, self.nb, self.k = d_new, nb_new, k
        flat = d_new.reshape(-1)
        nbD = torch.ones(S, dtype=torch.bool, device=d_new.device)
        torch.ne(nb_old, nb_new[:S_old], out=nbD[:S_old])
        dirty1 = torch.ones(S, V, dtype=torch.bool, device=d_new.device)
        torch.ne(d_old, d_new[:S_old], out=dirty1[:S_old])
        self.changed = dirty1.any(dim=1) | nbD
        sizes = [self.changed.sum()]
        self._top: list = []
        if k is not None:
            dirty1 |= nbD.index_select(0, flat).view(S, V)
            if k == 1:
                self._top = [(0, dirty1)]
            else:
                tail = dirty1
                for _ in range(k - 2):
                    tail = self._extend(dirty1, tail, 0, S)
                self._top = [(r0, self._extend(dirty1, tail, r0, r1))
                             for r0, r1 in _row_blocks(S, V ** k)]
            sizes.append(self._max_count(dirty1, flat))
            sizes += [m.sum() for _, m in self._top]
        self._sizes = torch.stack([n.long() for n in sizes])

    def _extend(self, dirty1, tail, r0: int, r1: int) -> torch.Tensor:
        """Rows r0..r1 of the next level up from ``tail`` [S, G]: bool
        [r1 - r0, V * G]."""
        V, G = dirty1.shape[1], tail.shape[1]
        d = self.d[r0:r1].reshape(-1)
        up = tail.index_select(0, d).view(r1 - r0, V, G)
        return (up | dirty1[r0:r1, :, None]).view(r1 - r0, V * G)

    def _max_count(self, dirty1, flat) -> torch.Tensor:
        """The largest new count of a changed cell, -1 where none, by
        ``max_gram_count``'s DP run beside its restriction to the changed
        cells: hd_j[m] is the largest count of a changed j-gram from m,
        h_j[m] of any (int64 past k = 1, as the JAX package's counts)."""
        S, V = dirty1.shape
        nb_d = self.nb.index_select(0, flat).view(S, V)
        nb64 = nb_d.long() if self.k > 1 else None
        # filled in place: at k = 1 nb_d is the diff's largest temporary
        hd = nb_d.masked_fill_(~dirty1, -1).amax(dim=1).long()
        h = None if nb64 is None else nb64.amax(dim=1)
        for _ in range(self.k - 1):
            hd_d = hd.index_select(0, flat).view(S, V)
            whole = nb64 + h.index_select(0, flat).view(S, V)
            hd = torch.where(dirty1, whole, torch.where(
                hd_d >= 0, nb64 + hd_d, -1)).amax(dim=1)
            h = whole.amax(dim=1)
        return hd.amax()

    def sizes(self) -> tuple:
        """(changed rows, changed cells, their largest new count, 0 where
        none), in one host sync."""
        got = self._sizes.tolist()
        self._n_rows, self._n_top = got[0], got[2:]
        if self.k is None:
            return self._n_rows, 0, 0
        return self._n_rows, sum(self._n_top), max(got[1], 0)

    def rows(self) -> torch.Tensor:
        """The changed rows, ascending (int64); after ``sizes()``."""
        return torch.nonzero_static(self.changed,
                                    size=self._n_rows).view(-1)

    def cells(self) -> tuple:
        """(cells, land, cnt) after ``sizes()``: the changed cells' flat
        indices into the [S_new * V^k] table, ascending (int64), their
        landing states (int32) and their counts (int64), recomputed by
        walking each gram's letters."""
        V, k = self.d.shape[1], self.k
        Vk = V ** k
        cells = torch.cat([
            torch.nonzero_static(m.view(-1), size=n).view(-1) + r0 * Vk
            for (r0, m), n in zip(self._top, self._n_top)])
        flat = self.d.reshape(-1)
        m = cells // Vk
        cnt = torch.zeros_like(cells)
        for i in range(k):
            c = cells // V ** (k - 1 - i) % V
            land = flat.index_select(0, m * V + c)
            cnt += self.nb.index_select(0, land)
            m = land.long()
        return cells, land, cnt


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
