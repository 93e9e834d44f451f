"""k-char stepped scan tables (host) and K3, the packed k-gram count.

Host half: ``choose_k``, ``compose_rows`` and ``build_stepped`` are the
numpy functions of the JAX package's ``ops/multistep.py``, which cannot be
imported without JAX. They build the packed table
``(next_state << count_bits) | gram_count`` over k-grams, so one gather
advances k symbols and counts every match inside them; the native threaded
``compose_pack`` does the work where it is available.

Device half: K3 (csrc/stepped_scan.cu) is the count of
``ops/multistep.py:stepped_count_core`` (``make_stepped_count_stream`` /
``_raw``), beside its plain PyTorch version. Inputs follow
``ops/scan_dense.py``, with ``halo = halo_steps * k`` and ``L % k == 0``.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._host import compose_pack, round_cap
from . import build
from .scan_dense import check_stream, window


@dataclass
class SteppedTables:
    k: int                      # symbols per gather
    V: int                      # base vocab size
    count_bits: int             # 0 when unpacked
    # int32 [S * V^k]; None where (state, count) need more than 31 bits —
    # the JAX package's two-table unpacked form, not ported (the snapshot
    # drops such a table)
    packed: Optional[np.ndarray]
    # capacity-padded backing buffer of ``packed`` (its first S*V^k
    # entries), set when build_stepped was given cap_rows
    cap_packed: Optional[np.ndarray] = None

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


def compose_rows(delta: np.ndarray, nb: np.ndarray, rows: np.ndarray,
                 k: int) -> tuple:
    """k-gram composition of a subset of state rows: (landing states
    [R, V^k] int32, summed match counts [R, V^k] int64)."""
    R = len(rows)
    d = delta[rows]                          # [R, V]
    cnt = nb[d].astype(np.int64)
    for _ in range(k - 1):
        d2 = delta[d]                        # [R, G, V]
        cnt = (cnt[..., None] + nb[d2]).reshape(R, -1)
        d = d2.reshape(R, -1)
    return d, cnt


def build_stepped(tables, k: int,
                  cap_rows: Optional[int] = None) -> SteppedTables:
    """Compose delta/nb_outputs over k-grams and pack. ``cap_rows``: also
    allocate the packed table inside a [cap_rows * V^k] zeroed capacity
    buffer (returned as ``cap_packed``)."""
    delta = tables.delta                     # [S, V]
    nb = tables.nb_outputs
    S, V = delta.shape
    # Exact max k-gram count by DP over tail lengths (O(S*V*k)):
    #   h_j[m] = max_c (nb[delta[m,c]] + h_{j-1}[delta[m,c]]), h_0 = 0.
    h = np.zeros(S, np.int64)
    for _ in range(k):
        h = (nb[delta] + h[delta]).max(axis=1)
    max_cnt = int(h.max()) if S else 0
    count_bits = max(1, int(max_cnt).bit_length()) if max_cnt else 1
    state_bits = max(1, int(S - 1).bit_length())
    # The JAX package's headroom for in-place refresh; kept so that both
    # packages build bit-identical tables.
    grow_bits = max(1, int(round_cap(S) - 1).bit_length())
    count_bits = max(count_bits,
                     min(count_bits + 3, 31 - max(state_bits, grow_bits)))
    if state_bits + count_bits <= 31:
        cap_buf = (np.zeros(cap_rows * V ** k, np.int32)
                   if cap_rows is not None and cap_rows >= S else None)
        return SteppedTables(k=k, V=V, count_bits=count_bits,
                             packed=pack(delta, nb, k, count_bits, cap_buf),
                             cap_packed=cap_buf)
    return SteppedTables(k=k, V=V, count_bits=0, packed=None)


def pack(delta: np.ndarray, nb: np.ndarray, k: int, count_bits: int,
         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Packed k-gram table [S * V^k] int32, into ``out`` when given: the
    native threaded compose, or numpy where the native core cannot be
    built."""
    try:
        return compose_pack(delta, nb, k, count_bits, out=out)
    except (OSError, subprocess.CalledProcessError):
        d, cnt = compose_rows(delta, nb, np.arange(len(delta)), k)
        packed = (((d.astype(np.int64) << count_bits) | cnt)
                  .astype(np.int32).reshape(-1))
        if out is None:
            return packed
        out[:packed.size] = packed
        return out[:packed.size]


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


def stepped_count_plain(packed, V: int, k: int, count_bits: int,
                        halo_steps: int, B: int, L: int, ext, lut=None,
                        head_ids=None) -> torch.Tensor:
    """Plain K3: per-stream int32 match totals [B] past the halo grams."""
    grams = combine_grams(window(B, L, halo_steps * k, ext, lut, head_ids),
                          V, k)
    mask, Vk = (1 << count_bits) - 1, V ** k
    s = torch.zeros(B, dtype=torch.int64, device=ext.device)
    tot = torch.zeros(B, dtype=torch.int32, device=ext.device)
    for j in range(grams.shape[0]):
        v = packed[s * Vk + grams[j]]
        s = (v >> count_bits).long()
        if j >= halo_steps:
            tot += v & mask
    return tot


def stepped_count(packed, V: int, k: int, count_bits: int, halo_steps: int,
                  B: int, L: int, ext, lut=None,
                  head_ids=None) -> torch.Tensor:
    """K3: per-stream int32 match totals [B]; the caller sums them in
    int64."""
    dev = check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids)
    if dev.type == "cpu":
        return stepped_count_plain(packed, V, k, count_bits, halo_steps, B,
                                   L, ext, lut, head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_stepped_count", dev, table=packed, ext=ext, lut=lut,
                 head_ids=head_ids, out=out, L=L, Vk=V ** k, B=B, V=V,
                 halo=halo_steps * k, ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k,
                 count_bits=count_bits)
    return out
