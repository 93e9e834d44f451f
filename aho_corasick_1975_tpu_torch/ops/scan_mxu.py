"""The MXU engine: the automaton's lookup as an int8 one-hot × digit-plane
product, and K10, its hand-written tensor-core kernel.

The port of ``ops/scan_mxu.py``. The step ``next = delta[s, c]`` is done
as arithmetic instead of a gather:

    row[b, :] = onehot(s_b) @ P                       (int8 product)
    e[b]      = sum_p row[b, p*V + c_b] << (7 * p)    (select-reduce)

where P stacks the packed word ``(next_state << count_bits) | count`` of
every (state, letter) as 7-bit digit planes, so every int8 × int8 → int32
product is exact (a one-hot row has exactly one non-zero). The JAX
package picked this engine on a TPU v5e for automata of at most
``MAX_MXU_STATES`` padded states; that crossover is a TPU measurement and
says nothing of the H100 (ROADMAP), so the port selects it only when asked
(``engine="mxu"``) or when its own calibration measures it faster.

Host half: ``build_planes`` is the numpy function of the JAX module, which
cannot be imported without JAX; its planes are bit-identical.

Device half: K10 (csrc/mxu_scan.cu) replaces ``mxu_count_core`` in the
forms of ``make_mxu_count_stream`` / ``_raw`` (``mxu_count``),
``make_mxu_count_many`` (``mxu_count_many``) and, in ``ops/sparse.py``,
``make_mxu_count_halo`` and ``make_sparse_count_mxu[_dev]``
(``sparse_count_mxu``). It reads the planes keyed by (state, letter):
``planes_t`` of ``transpose_planes``, [n_planes, S_pad*V] plane-major, so
that row b's one-hot has its 1 at key ``s_b*V + c_b`` and one ``mma.sync``
m16n8k32 int8 product of a 32-key tile gives every plane's digit of every
row whose key lies in it: no select-reduce over the letter. One warp owns
R streams (``AC_K10_ROWS`` in csrc/ac_scan.cuh) and multiplies, per
symbol, each distinct key tile among them once, accumulating in D. The
scanners make ``planes_t`` once per bind, beside the planes, which stay
bit-identical to the JAX package's and remain the plain versions' input.
Each version here
beside its plain PyTorch one, which multiplies in float32: exact, since
the digits are below 2^7 and each product sums one non-zero term (TF32
would be exact too: 7-bit integers fit its mantissa).

Inputs follow ``ops/scan_dense.py``; ``planes`` is the int8 tensor
[S_pad, n_planes * V] of ``build_planes`` on the scan's device, and every
wrapper takes its ``planes_t`` too, which a launch on the card reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .scan_dense import check_batch, check_stream, split_window, window

# The JAX package's bound on the engine (its v5e crossover against the
# k=2 packed gather); kept so that both packages accept the same automata.
MAX_MXU_STATES = 512

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1

def build_planes(delta: np.ndarray, nb_outputs: np.ndarray,
                 max_states: Optional[int] = None
                 ) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """Pack the dense tables into int8 digit planes for the MXU kernel.

    Returns (planes int8 [S_pad, n_planes*V], count_bits, n_planes, S_pad)
    or None when the automaton is too big for this engine (padded states
    over ``max_states`` — default MAX_MXU_STATES; the hybrid engine
    passes its own larger envelope — or the packed word would need > 4
    digits)."""
    S, V = delta.shape
    S_pad = max(128, -(-int(S * 9 / 8 + 1) // 128) * 128)  # growth headroom
    if S_pad > (max_states if max_states is not None else MAX_MXU_STATES):
        return None
    max_cnt = int(nb_outputs.max()) if S else 0
    count_bits = max(1, max_cnt.bit_length())
    # headroom for online insertions raising counts (mirrors multistep)
    count_bits = min(count_bits + 3, 28 - max(1, (S_pad - 1).bit_length()))
    if count_bits < max(1, max_cnt.bit_length()):
        return None
    state_bits = max(1, (S_pad - 1).bit_length())
    total_bits = state_bits + count_bits
    n_planes = -(-total_bits // DIGIT_BITS)
    if n_planes > 4:
        return None
    packed = ((delta.astype(np.int64) << count_bits)
              | nb_outputs[delta].astype(np.int64)).astype(np.int32)
    planes = np.zeros((S_pad, n_planes * V), np.int8)
    for p in range(n_planes):
        planes[:S, p * V:(p + 1) * V] = \
            ((packed >> (DIGIT_BITS * p)) & DIGIT_MASK).astype(np.int8)
    return planes, count_bits, n_planes, S_pad


def mxu_count_window(planes, V: int, count_bits: int, n_planes: int,
                     halo: int, win: torch.Tensor) -> torch.Tensor:
    """int32 match totals per column of [rows, n] letter ids, rows past
    the halo (``ops/scan_mxu.py:mxu_count_core``), in plain PyTorch."""
    n = win.shape[1]
    dev = win.device
    P = planes.to(torch.float32)
    eyeS = torch.arange(planes.shape[0], device=dev)
    eyeV = torch.arange(V, device=dev)
    mask = (1 << count_bits) - 1
    s = torch.zeros(n, dtype=torch.int64, device=dev)
    tot = torch.zeros(n, dtype=torch.int32, device=dev)
    for t in range(win.shape[0]):
        R = (s[:, None] == eyeS[None, :]).to(torch.float32) @ P
        oc = (win[t][:, None] == eyeV[None, :]).to(torch.float32)
        e = torch.zeros(n, dtype=torch.int64, device=dev)
        for p in range(n_planes):
            e += (R[:, p * V:(p + 1) * V] * oc).sum(dim=1).long() \
                << (DIGIT_BITS * p)
        if t >= halo:
            tot += (e & mask).to(torch.int32)
        s = e >> count_bits
    return tot


def check_planes(planes: torch.Tensor, V: int, n_planes: int) -> None:
    if (planes.dtype != torch.int8 or planes.dim() != 2
            or planes.shape[1] != n_planes * V or planes.shape[0] % 32
            or not planes.is_contiguous()):
        raise ValueError(
            f"planes must be contiguous int8 [S_pad, n_planes*V] with S_pad "
            f"a multiple of 32 (got {planes.dtype} {tuple(planes.shape)}, "
            f"n_planes={n_planes}, V={V})")


def key_stride(S_pad: int, V: int) -> int:
    """The key axis of ``planes_t``: S_pad*V rounded up to a whole 32-key
    tile (csrc/ac_scan.cuh:ac_key_stride)."""
    return -(-S_pad * V // 32) * 32


def transpose_planes(planes: torch.Tensor, V: int,
                     n_planes: int) -> torch.Tensor:
    """The planes keyed by (state, letter), K10's and K11's B operand:
    int8 [n_planes, key_stride(S_pad, V)] with
    ``planes_t[p, s*V + c] = planes[s, p*V + c]`` and zeros past S_pad*V,
    on the planes' device."""
    check_planes(planes, V, n_planes)
    S_pad = planes.shape[0]
    out = torch.zeros((n_planes, key_stride(S_pad, V)), dtype=torch.int8,
                      device=planes.device)
    out[:, :S_pad * V] = planes.view(S_pad, n_planes, V).permute(
        1, 0, 2).reshape(n_planes, S_pad * V)
    return out


def mxu_fields(planes: torch.Tensor, V: int, count_bits: int, n_planes: int,
               planes_t: Optional[torch.Tensor]) -> dict:
    """The launch fields of the planes; raises unless ``planes_t`` is
    ``transpose_planes(planes)``'s shape on the planes' device. Every
    wrapper checks it, on the CPU too, where its plain version reads the
    planes."""
    if (planes_t is None or planes_t.dtype != torch.int8
            or tuple(planes_t.shape) != (n_planes,
                                         key_stride(planes.shape[0], V))
            or not planes_t.is_contiguous()
            or planes_t.device != planes.device or planes_t.data_ptr() % 16):
        raise ValueError(
            "a launch needs planes_t, transpose_planes(planes) on the "
            "planes' device (the scanners make it once per bind); got "
            + ("None" if planes_t is None else
               f"{planes_t.dtype} {tuple(planes_t.shape)} on "
               f"{planes_t.device}"))
    return dict(planes_t=planes_t, S_pad=planes.shape[0], n_planes=n_planes,
                count_bits_m=count_bits, V=V)


def mxu_count_plain(planes, V: int, count_bits: int, n_planes: int,
                    halo: int, B: int, L: int, ext, lut=None,
                    head_ids=None) -> torch.Tensor:
    """Plain K10 stream form: per-stream int32 match totals [B]."""
    return mxu_count_window(planes, V, count_bits, n_planes, halo,
                            window(B, L, halo, ext, lut, head_ids))


def mxu_count(planes, V: int, count_bits: int, n_planes: int, halo: int,
              B: int, L: int, ext, lut=None, head_ids=None, *,
              planes_t: torch.Tensor) -> torch.Tensor:
    """K10 stream form (``make_mxu_count_stream`` / ``_raw``): per-stream
    int32 match totals [B]; the caller sums them in int64. Forms "ids"
    and "raw"."""
    check_planes(planes, V, n_planes)
    dev = check_stream(B, L, halo, ext, lut, head_ids)
    if planes.device != dev:
        raise ValueError(f"inputs on {planes.device} and {dev}")
    fields = mxu_fields(planes, V, count_bits, n_planes, planes_t)
    if dev.type == "cpu":
        return mxu_count_plain(planes, V, count_bits, n_planes, halo, B, L,
                               ext, lut, head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_mxu_count", dev, form="ids" if lut is None else "raw",
                 ext=ext, lut=lut, head_ids=head_ids, out=out, L=L, B=B,
                 halo=halo, ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), layout=0,
                 **fields)
    return out


def mxu_count_many_plain(planes, V: int, count_bits: int, n_planes: int,
                         halo: int, c: int, Lp: int, tm,
                         lut=None) -> torch.Tensor:
    """Plain K10 batch form: int32 match totals per batch column [c*B];
    column i*B + j holds block i of document j."""
    return mxu_count_window(planes, V, count_bits, n_planes, halo,
                            split_window(c, Lp, halo, tm, lut))


def mxu_count_many(planes, V: int, count_bits: int, n_planes: int,
                   halo: int, c: int, Lp: int, tm, lut=None, *,
                   planes_t: torch.Tensor) -> torch.Tensor:
    """K10 batch form (``make_mxu_count_many``): int32 match totals per
    batch column [c*B] of the time-major batch ``tm`` [L, B] (int32 ids,
    or raw uint8/int32 symbols with ``lut``) split into c blocks of Lp
    with a ``halo`` from the same document; the caller sums each
    document's c blocks in int64."""
    check_planes(planes, V, n_planes)
    dev = check_batch(c, Lp, tm, lut)
    if planes.device != dev:
        raise ValueError(f"inputs on {planes.device} and {dev}")
    fields = mxu_fields(planes, V, count_bits, n_planes, planes_t)
    if dev.type == "cpu":
        return mxu_count_many_plain(planes, V, count_bits, n_planes, halo, c,
                                    Lp, tm, lut)
    L, B = tm.shape
    out = torch.empty(c * B, dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    build.launch("ac_mxu_count", dev, form="batch", ext=tm, lut=lut, out=out,
                 L=Lp, B=c * B, halo=halo,
                 ext_u8=int(tm.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), doc_len=L,
                 n_docs=B, layout=1, **fields)
    return out
