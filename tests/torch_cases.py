"""Seeded inputs shared by the port's op tests (tests/test_torch_ops.py,
tests/test_torch_kernel_body.py): automaton tables from the port's own
snapshot and the JAX package's k-gram composer, and stream buffers, count_many batches and the prefilter's
mostly-OOV streams made with numpy, at small sizes."""

from __future__ import annotations

import random

import numpy as np

from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu_torch import Machine
from aho_corasick_1975_tpu_torch.models.snapshot import DeviceSnapshot
from aho_corasick_1975_tpu_torch.ops.multistep import (emit_warm_steps_for,
                                                       warm_steps_for)
from aho_corasick_1975_tpu_torch.ops.sparse import elide_windows

KINDS = ("ids", "raw_u8", "raw_i32")
B = 8


def keywords(seed: int = 0) -> list:
    """The 40 byte keywords of ``machine(seed)``: 1-6 letters of "abcd"."""
    rng = random.Random(seed)
    return [bytes(rng.choice(b"abcd") for _ in range(rng.randint(1, 6)))
            for _ in range(40)]


def machine(seed: int = 0) -> Machine:
    m = Machine()
    for kw in keywords(seed):
        m.insert_keyword(kw)
    return m


def tables(k: int, seed: int = 0) -> dict:
    """The automaton's capacity-padded tables as numpy arrays: the 1-char
    tables (``n_states`` of their rows real), the packed k-gram table and
    the packed k=1 table ``pk1``, and the stepped kernels' warm-up in grams
    of k (at k = 1 the 1-char kernels' warm-up in symbols), and K4's
    (``emit_warm``)."""
    m = machine(seed)
    t = m.compile()
    snap = DeviceSnapshot(t, step_k=1, device="cpu")
    st = jms.build_stepped(t, k, cap_rows=snap.cap)
    cb1 = max(1, snap.max_nb.bit_length())
    d1, cnt1 = jms.compose_rows(t.delta, t.nb_outputs, np.arange(t.n_states),
                                1)
    lut = m.vocab.byte_lut()
    return dict(machine=m, V=snap.V, k=k, count_bits=st.count_bits,
                n_states=t.n_states,
                dflat=snap.dflat.numpy(), nb_out=snap.nb_out.numpy(),
                packed=st.cap_packed, cb1=cb1,
                pk1=((d1.astype(np.int64) << cb1) | cnt1).astype(
                    np.int32).ravel(),
                warm_steps=warm_steps_for(t, k),
                emit_warm=emit_warm_steps_for(t, k),
                byte_lut=np.where(lut < snap.V, lut, 0).astype(np.int32))


def stream(tab: dict, kind: str, halo: int, L: int, seed: int = 1) -> dict:
    """ext [halo + B*L] of one kind, with the LUT and non-zero head_ids
    of the raw kinds. Raw int32 symbols run past the LUT's end, so the
    clamp of the lookup is exercised."""
    rng = np.random.default_rng(seed)
    n = halo + B * L
    V = tab["V"]
    if kind == "ids":
        ext = rng.integers(0, V, n).astype(np.int32)
        return dict(ext=ext, lut=None, head_ids=None)
    if kind == "raw_u8":
        ext = rng.choice(np.frombuffer(b"abcdabcdxy\0", np.uint8), n)
    else:
        ext = rng.choice(np.array([97, 98, 99, 100, 0, 120, 255, 256, 4000],
                                  np.int32), n)
    head_ids = rng.integers(1, V, halo).astype(np.int32)
    return dict(ext=ext, lut=tab["byte_lut"], head_ids=head_ids)


def batch(tab: dict, kind: str, L: int, n_docs: int = 4, seed: int = 2
          ) -> dict:
    """A time-major count_many batch tm [L, n_docs] of one kind, with the
    LUT of the raw kinds (raw int32 symbols run past the LUT's end)."""
    rng = np.random.default_rng(seed)
    if kind == "ids":
        tm = rng.integers(0, tab["V"], (L, n_docs)).astype(np.int32)
        return dict(tm=tm, lut=None)
    if kind == "raw_u8":
        tm = rng.choice(np.frombuffer(b"abcdabcdxy\0", np.uint8), (L, n_docs))
    else:
        tm = rng.choice(np.array([97, 98, 99, 100, 0, 120, 255, 256, 4000],
                                 np.int32), (L, n_docs))
    return dict(tm=tm, lut=tab["byte_lut"])


# Window blocks of the prefilter's op tests per k (multiples of k), and
# the live blocks of its streams: block 0 (so the head is read),
# neighbours (a halo from a live block) and the last real block.
L_BLK = {1: 16, 2: 16, 3: 24}
LIVE = (0, 3, 4, 9, 11)
N_BLOCKS = 12


def sparse(tab: dict, halo: int, L_blk: int, kind: str = "ids",
           seed: int = 3) -> dict:
    """A mostly-OOV stream of N_BLOCKS blocks of L_blk for the window
    scans, keyword letters only in the blocks LIVE, in both window
    sources: ext [halo + (nB+1)*L_blk] int32 ids (non-zero head ids in
    front, one all-OOV spare block at the end) with idx [cap] int32 (the
    live blocks, then pad slots at the spare block nB), and the
    host-elided windows tm [halo + L_blk, cap] of the same stream with
    their int32 block indices tm_idx. ``kind`` "raw_u8" elides from raw
    bytes through the byte LUT."""
    rng = np.random.default_rng(seed)
    nB, T = N_BLOCKS, N_BLOCKS * L_blk
    head = rng.integers(1, tab["V"], halo).astype(np.int32)
    raw = np.zeros(T, np.uint8)
    for b in LIVE:
        seg = rng.choice(np.frombuffer(b"abcdabcdxy\0", np.uint8), L_blk)
        raw[b * L_blk:(b + 1) * L_blk] = seg * (rng.random(L_blk) < 0.7)
    ids = tab["byte_lut"][raw]
    ext = np.zeros(halo + (nB + 1) * L_blk, np.int32)
    ext[:halo] = head
    ext[halo:halo + T] = ids
    live = np.zeros(nB, bool)
    live[list(LIVE)] = True
    idx = np.full(8, nB, np.int32)
    idx[:len(LIVE)] = LIVE
    arr, lut = (ids, None) if kind == "ids" else (raw, (tab["byte_lut"], 256))
    tm, tm_idx = elide_windows(arr, lut, T, live, len(LIVE), head, halo,
                               L_blk, nB)
    return dict(ext=ext, idx=idx, nB=nB, T=T, ids=ids, raw=raw, head=head,
                live=live, tm=tm, tm_idx=tm_idx.astype(np.int32))


def same_hits(got, want) -> None:
    """K8's exact-size outputs (positions, states, n_hits, n_hit_pos)
    against the JAX package's -1 padded max_hits buffers (positions,
    states, n_hits, n_hit_pos)."""
    positions, states, n_hits, n_hit_pos = got
    j_pos, j_st = np.asarray(want[0]), np.asarray(want[1])
    valid = j_pos >= 0
    assert str(positions.dtype) == str(states.dtype) == "torch.int32"
    assert positions.numel() == n_hit_pos == int(want[3]) == valid.sum() > 0
    np.testing.assert_array_equal(positions.numpy(), j_pos[valid])
    np.testing.assert_array_equal(states.numpy(), j_st[valid])
    assert n_hits == int(want[2])
