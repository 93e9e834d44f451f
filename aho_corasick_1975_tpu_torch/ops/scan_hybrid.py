"""The hybrid count engine: part of the streams through the packed k-gram
gather, the rest through the MXU engine, in one launch; K11, its
hand-written kernel.

The port of ``ops/scan_hybrid.py``. The first B1 stream columns run K3's
recurrence (one gather of the packed k-gram table per k symbols), the last
B2 = ``mxu_cols(B, S_pad)`` columns K10's (one int8 one-hot × digit-plane
product per symbol, so k sub-steps per gram step), both counting from gram
step ``halo_steps``; the per-stream totals concatenate as one engine's
would. On a TPU v5e the MXU columns rode in the gather's issue shadow; the
split constants below (``MAX_HYBRID_STATES``, ``MXU_FRACTION``,
``mxu_cols``) are that chip's measurements, kept as the JAX formula so
that both packages split alike, and are to be measured again on the card
(ROADMAP).

K11 (csrc/mxu_scan.cu) replaces ``hybrid_count_core``
(``make_hybrid_count_stream`` / ``_raw``): the launch's blocks take a role
by index, MMA blocks first, one warp per R columns of [B1, B)
(``AC_K11_ROWS`` in csrc/ac_scan.cuh) running K10's body over
``planes_t``, then gather blocks running K3's sub-streams over the
columns of [0, B1).
"""

from __future__ import annotations

import torch

from . import build
from .multistep import _count_grams, check_stepped, split_fields
from .scan_dense import window
from .scan_mxu import check_planes, mxu_count_window, mxu_fields

# The JAX package's envelope of the engine (padded states), kept so that
# both packages accept the same automata.
MAX_HYBRID_STATES = 8192

# MXU columns per gather column at S_pad of about 4k, the JAX package's
# v5e choice; scaled inversely with S_pad by mxu_cols.
MXU_FRACTION = 32


def mxu_cols(B: int, S_pad: int) -> int:
    """How many of B total stream columns to scan on the MXU engine (the
    JAX package's formula): ~B/32 at S_pad≈4k, scaled down with the
    automaton's size; a multiple of 8, at least 8, at most B/2."""
    b2 = B * 3968 // (MXU_FRACTION * max(S_pad, 1))
    return max(8, min(B // 2, b2 // 8 * 8))


def hybrid_count_plain(packed, planes, V: int, k: int, count_bits: int,
                       halo_steps: int, n_planes: int, count_bits_m: int,
                       B1: int, B: int, L: int, ext, lut=None,
                       head_ids=None) -> torch.Tensor:
    """Plain K11: per-stream int32 match totals [B], columns [0, B1)
    through the packed table, [B1, B) through the planes."""
    win = window(B, L, halo_steps * k, ext, lut, head_ids)
    return torch.cat([
        _count_grams(packed, V, k, count_bits, halo_steps, win[:, :B1]),
        mxu_count_window(planes, V, count_bits_m, n_planes, halo_steps * k,
                         win[:, B1:])])


def hybrid_count(packed, planes, V: int, k: int, count_bits: int,
                 halo_steps: int, n_planes: int, count_bits_m: int, B1: int,
                 B: int, L: int, ext, lut=None, head_ids=None, *,
                 planes_t: torch.Tensor, warm_steps: int,
                 split: int = 0) -> torch.Tensor:
    """K11: per-stream int32 match totals [B] (the gather half's B1, then
    the MXU half's B - B1); the caller sums them in int64. Forms "ids"
    and "raw". The gather half's streams run as ``split`` sub-streams
    each, as K3's (``multistep.split_fields``)."""
    check_planes(planes, V, n_planes)
    sub = split_fields(V, k, warm_steps, split)
    if not 0 <= B1 <= B:
        raise ValueError(f"B1={B1} outside [0, B={B}]")
    dev = check_stepped(packed, k, halo_steps, B, L, ext, lut, head_ids)
    if planes.device != dev:
        raise ValueError(f"inputs on {planes.device} and {dev}")
    fields = mxu_fields(planes, V, count_bits_m, n_planes, planes_t)
    if dev.type == "cpu":
        return hybrid_count_plain(packed, planes, V, k, count_bits,
                                  halo_steps, n_planes, count_bits_m, B1, B,
                                  L, ext, lut, head_ids)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch("ac_hybrid_count", dev, form="ids" if lut is None else "raw",
                 table=packed, ext=ext, lut=lut, head_ids=head_ids, out=out,
                 L=L, Vk=V ** k, B=B, B1=B1, halo=halo_steps * k,
                 ext_u8=int(ext.dtype == torch.uint8),
                 n_lut=0 if lut is None else lut.numel(), k=k,
                 count_bits=count_bits, layout=0, **fields, **sub)
    return out
