"""The CUDA kernels' per-thread code, run on the CPU.

csrc/ac_scan.cuh holds everything one CUDA thread of K1-K8 computes. The
host shim csrc/ac_scan_host.cpp compiles it with g++ behind the kernels'
own C entry points, so the logic the H100 runs is checked here against the
plain PyTorch versions, with exact equality: k in {1, 2, 3}, a halo longer
than a stream, raw uint8 and int32 inputs with non-zero head_ids. The
count_many bodies (K5, K6) are also held, column by column, against the
JAX package's count over ``split_docs_layout`` and, document by document,
against its ``make_stepped_count_many`` / ``make_blocked_count_many``.
The prefilter's bodies, K7 (window counts over an index list and over
host-elided windows) and K8 (the bounded hits of streams and windows, both
passes into buffers of exactly the hit count), and K2's one-thread and
time-major modes are held against the JAX package's ``ops/sparse.py``,
``ops/hits.py`` and ``ops/scan_xla.py`` functions. K9 (the two-table
count, stream and batch forms), K10 (the MXU engine's warp body, whose
``mma.sync`` the g++ build emulates lane by lane from the PTX fragment
layout, in every form) and K11 (the hybrid launch) are held against the
JAX package's ``ops/multistep.py``, ``ops/scan_mxu.py``,
``ops/scan_hybrid.py`` and ``ops/sparse.py`` functions. K12's three phases
(each chunk's and each tile's composed function, and each chunk re-run
from its start) are held against the JAX package's
``ops/scan_assoc.py:make_assoc_scan`` at several chunk and tile sizes,
and against each other. The split kernels (K3, K4, K5, K9, K11's gather
half, and at k = 1 K1, K2's stream and time-major forms, K6 and K8's two
forms: each column as P sub-streams, each warmed up over the tables'
warm_steps, K4's a symbol longer) are forced to every P up to 32 and held
against the plain versions and the JAX package (K4 also where a longest
keyword ends just before each sub-stream, which K3's warm-up would miss;
the 1-char kernels also
over the 1-char tables staged as on the SM and read in place, K2's states
and K8's positions and states element for element, K2's staged state
writes at every alignment; K2's and K8's stream forms also where keywords
of 64 and 70 bytes end on every sub-stream's first row), and the
launcher's pick of P is held at the slice's, config 3's and the step_k=1
slice's shapes.
"""

import ctypes
import functools
import os
import random
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from aho_corasick_1975_tpu.ops import hits as jhits
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu.ops import scan_hybrid as jhybrid
from aho_corasick_1975_tpu.ops import scan_mxu as jmxu
from aho_corasick_1975_tpu.ops import scan_xla as jxla
from aho_corasick_1975_tpu.ops import sparse as jsp
from aho_corasick_1975_tpu_torch import Machine
from aho_corasick_1975_tpu_torch.models.snapshot import DeviceSnapshot
from aho_corasick_1975_tpu_torch.ops import (build, hits, multistep,
                                             scan_dense, scan_hybrid,
                                             scan_mxu, sparse)

B = tc.B
SHAPES = {"halo": (5, 24), "long_halo": (9, 4)}


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build.host_library()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _run(lib, name, **fields):
    args = build.scan_args(**fields)
    assert getattr(lib, name)(ctypes.byref(args), None) == 0


def _common(s, halo, L, V):
    ext = _t(s["ext"])
    return dict(ext=ext, lut=_t(s["lut"]), head_ids=_t(s["head_ids"]), L=L,
                B=B, V=V, halo=halo, ext_u8=int(ext.dtype == torch.uint8),
                n_lut=0 if s["lut"] is None else len(s["lut"]))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_kernels(lib, kind, shape):
    tab = tc.tables(1)
    halo, L = SHAPES[shape]
    s = tc.stream(tab, kind, halo, L)
    V, dflat, nb_out = tab["V"], _t(tab["dflat"]), _t(tab["nb_out"])
    plain_args = (V, halo, B, L, _t(s["ext"]), _t(s["lut"]),
                  _t(s["head_ids"]))
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_count", table=dflat, nb_out=nb_out, out=out,
         warm_steps=tab["warm_steps"], **_common(s, halo, L, V))
    want = scan_dense.dense_count_plain(dflat, nb_out, *plain_args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    states = torch.full((B * L,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_states", table=dflat, out=states,
         warm_steps=tab["warm_steps"], **_common(s, halo, L, V))
    assert torch.equal(states, scan_dense.dense_states_plain(dflat,
                                                             *plain_args))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_kernels(lib, k, kind, shape):
    tab = tc.tables(k)
    halo_steps = -(-SHAPES[shape][0] // k)
    L = 8 * k if shape == "halo" else 2 * k
    s = tc.stream(tab, kind, halo_steps * k, L)
    V, cb, packed = tab["V"], tab["count_bits"], _t(tab["packed"])
    common = dict(_common(s, halo_steps * k, L, V), Vk=V ** k, k=k,
                  count_bits=cb, warm_steps=tab["warm_steps"])
    plain_args = (packed, V, k, cb, halo_steps, B, L, _t(s["ext"]),
                  _t(s["lut"]), _t(s["head_ids"]))
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_count", table=packed, out=out, **common)
    want = multistep.stepped_count_plain(*plain_args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    emit = torch.full((B, L // k), -7, dtype=torch.int32)
    n_hits = torch.full((B,), -7, dtype=torch.int32)
    n_live = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_emit", table=packed, out=emit, n_hits=n_hits,
         n_live=n_live, **dict(common, warm_steps=tab["emit_warm"]))
    for got, want in zip((emit, n_hits, n_live),
                         hits.stepped_emit_plain(*plain_args)):
        assert torch.equal(got, want)


def _many_shape(k, c):
    """(L, Lp): c blocks of Lp (a multiple of k), the last one short."""
    return (3 * 8 * k - k, 8 * k) if c == 3 else (8 * k, 8 * k)


def _jax_many(b, c, Lp, halo, core, make, tables):
    """The JAX package's count_many of batch b: per column (its core over
    split_docs_layout) and per document (the jitted factory's result)."""
    tm = jnp.asarray(b["tm"])
    lut = None if b["lut"] is None else jnp.asarray(b["lut"])
    w = tm if lut is None else lut[tm.astype(jnp.int32)]
    if c > 1:
        w = jxla.split_docs_layout(w, c, Lp, halo)
    per_col = core(halo if c > 1 else 0, w)
    fn = make(lut is not None)
    per_doc = fn(*tables, tm) if lut is None else fn(*tables, lut, tm)
    return np.asarray(per_col), np.asarray(per_doc)


def _many_common(b, c, L, Lp, halo, V):
    tm = _t(b["tm"])
    n_docs = tm.shape[1]
    return dict(ext=tm, lut=_t(b["lut"]), L=Lp, B=c * n_docs, V=V,
                halo=halo, ext_u8=int(tm.dtype == torch.uint8),
                n_lut=0 if b["lut"] is None else len(b["lut"]), doc_len=L,
                n_docs=n_docs)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_count_many_kernel(lib, k, kind, c):
    tab = tc.tables(k)
    V, cb = tab["V"], tab["count_bits"]
    L, Lp = _many_shape(k, c)
    hs = -(-5 // k) if c > 1 else 0
    b = tc.batch(tab, kind, L)
    packed = _t(tab["packed"])
    out = torch.full((c * 4,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_count_many", table=packed, out=out, Vk=V ** k, k=k,
         count_bits=cb, warm_steps=tab["warm_steps"],
         **_many_common(b, c, L, Lp, hs * k, V))
    want = multistep.stepped_count_many_plain(packed, V, k, cb, hs, c, Lp,
                                              _t(b["tm"]), _t(b["lut"]))
    assert torch.equal(out, want) and int(want.sum()) > 0
    per_col, per_doc = _jax_many(
        b, c, Lp, hs * k,
        lambda h, w: jms.stepped_count_core(V, k, V ** k, cb, h // k,
                                            jnp.asarray(tab["packed"]), w),
        lambda raw: jms.make_stepped_count_many(V, k, V ** k, cb, hs, c, Lp,
                                                raw),
        (jnp.asarray(tab["packed"]),))
    np.testing.assert_array_equal(out.numpy(), per_col)
    np.testing.assert_array_equal(
        out.view(c, -1).sum(dim=0, dtype=torch.int64).numpy(), per_doc)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_count_many_kernel(lib, kind, c):
    tab = tc.tables(1)
    V = tab["V"]
    L, Lp = (61, 24) if c == 3 else (24, 24)
    halo = 5 if c > 1 else 0
    b = tc.batch(tab, kind, L)
    dflat, nb_out = _t(tab["dflat"]), _t(tab["nb_out"])
    out = torch.full((c * 4,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_count_many", table=dflat, nb_out=nb_out, out=out,
         warm_steps=tab["warm_steps"], **_many_common(b, c, L, Lp, halo, V))
    want = scan_dense.dense_count_many_plain(dflat, nb_out, V, halo, c, Lp,
                                             _t(b["tm"]), _t(b["lut"]))
    assert torch.equal(out, want) and int(want.sum()) > 0
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    per_col, per_doc = _jax_many(
        b, c, Lp, halo,
        lambda h, w: jxla.blocked_count_core(V, h, *jt, w),
        lambda raw: jxla.make_blocked_count_many(V, halo, c, Lp, raw), jt)
    np.testing.assert_array_equal(out.numpy(), per_col)
    np.testing.assert_array_equal(
        out.view(c, -1).sum(dim=0, dtype=torch.int64).numpy(), per_doc)


# -- K7, K8 and the K2 modes --------------------------------------------------

def _win_fields(s, form, L_blk):
    """Launch fields of one window source of tc.sparse's case s."""
    if form == "idx":
        src, idx = _t(s["ext"]), _t(s["idx"])
    else:
        src, idx = _t(s["tm"]), _t(s["tm_idx"])
    fields = sparse.window_fields(L_blk, src, idx)
    fields.pop("form")
    return src, idx, fields


@pytest.mark.parametrize("form", ["idx", "elided"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sparse_count_kernels(lib, k, form):
    """K7's bodies (stepped; dense at k = 1) over both window sources,
    against the JAX sparse count and the JAX count of the elided
    windows; K7 dense at its launcher's pick (which its ``_split`` query
    gives) and forced to every P of SPLITS (windows of 16 symbols: empty
    sub-streams past 16), each warmed up over the tables' max_depth - 1
    symbols, and against its plain version."""
    tab = tc.tables(k)
    V, cb, L_blk = tab["V"], tab["count_bits"], tc.L_BLK[k]
    hs = -(-5 // k)
    s = tc.sparse(tab, hs * k, L_blk)
    src, idx, fields = _win_fields(s, form, L_blk)
    out = torch.full((fields["B"],), -7, dtype=torch.int32)
    _run(lib, "ac_sparse_count_stepped", table=_t(tab["packed"]), out=out,
         L=L_blk, Vk=V ** k, V=V, halo=hs * k, k=k, count_bits=cb, **fields)
    if form == "idx":
        want = jsp.make_sparse_count_stepped(V, k, V ** k, cb, hs, L_blk,
                                             s["nB"], len(s["idx"]))(
            jnp.asarray(tab["packed"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["idx"]))
    else:
        want = jms.make_stepped_count(V, k, V ** k, cb, hs)(
            jnp.asarray(tab["packed"]), jnp.asarray(s["tm"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert int(out.sum()) > 0
    if k > 1:
        return
    halo = hs
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    if form == "idx":
        want = jsp.make_sparse_count(V, halo, L_blk, s["nB"], 8)(
            *jt, jnp.asarray(s["ext"]), jnp.asarray(s["idx"]))
    else:
        want = jxla.make_blocked_count(V, halo)(*jt, jnp.asarray(s["tm"]))
    plain = sparse.sparse_count_plain(
        _t(tab["dflat"]), _t(tab["nb_out"]), V, halo, L_blk, src,
        idx if form == "idx" else None)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    dense_fields = dict(table=_t(tab["dflat"]), nb_out=_t(tab["nb_out"]),
                        L=L_blk, V=V, halo=halo,
                        warm_steps=tab["warm_steps"],
                        n_states=tab["n_states"], **fields)
    P = ctypes.c_int(0)
    args = build.scan_args(**dense_fields)
    assert lib.ac_sparse_count_split(ctypes.byref(args), ctypes.byref(P)) == 0
    for split in [0] + SPLITS:
        dense = torch.full((fields["B"],), -7, dtype=torch.int32)
        _run(lib, "ac_sparse_count", out=dense, split=split, **dense_fields)
        assert lib.ac_last_split() == (split or P.value)
        np.testing.assert_array_equal(dense.numpy(), np.asarray(want))


def _hits_two_pass(lib, name, n_cols, offset=0, **fields):
    """Both K8 passes through the g++ build at the P its launcher gives
    (``<name>_split``), as ops/hits.py runs them: pass 1's per-sub-stream
    counts, then pass 2 into buffers of exactly n_hit_pos entries plus a
    sentinel slot that must stay untouched, ``offset`` entries into their
    allocation."""
    P = ctypes.c_int(0)
    args = build.scan_args(**fields)
    assert getattr(lib, f"{name}_split")(ctypes.byref(args),
                                         ctypes.byref(P)) == 0
    fields = dict(fields, split=P.value)
    n_hits = torch.full((n_cols * P.value,), -7, dtype=torch.int32)
    n_pos = torch.full((n_cols * P.value,), -7, dtype=torch.int32)
    _run(lib, name, n_hits=n_hits, n_live=n_pos, **fields)
    total = int(n_pos.sum())
    pos = torch.full((offset + total + 1,), -7, dtype=torch.int32)[offset:]
    st = torch.full((offset + total + 1,), -7, dtype=torch.int32)[offset:]
    off = torch.cumsum(n_pos, 0, dtype=torch.int64) - n_pos
    _run(lib, name, hit_pos=pos, hit_state=st, hit_off=off, **fields)
    assert int(pos[-1]) == int(st[-1]) == -7
    return pos[:-1], st[:-1], int(n_hits.sum(dtype=torch.int64)), total


@pytest.mark.parametrize("form", ["idx", "elided", "elided_raw"])
def test_window_hits_kernel(lib, form):
    """K8's window body against make_sparse_hits / make_elided_hits."""
    tab = tc.tables(1)
    V, L_blk, halo = tab["V"], 16, 5
    s = tc.sparse(tab, halo, L_blk, "raw_u8" if form == "elided_raw"
                  else "ids")
    src, idx, fields = _win_fields(s, "idx" if form == "idx" else "elided",
                                   L_blk)
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    got = _hits_two_pass(lib, "ac_window_hits", fields.pop("B"),
                         table=_t(tab["dflat"]), nb_out=_t(tab["nb_out"]),
                         L=L_blk, B=idx.numel(), V=V, halo=halo,
                         warm_steps=tab["warm_steps"], **fields)
    if form == "idx":
        want = jsp.make_sparse_hits(V, halo, L_blk, s["nB"], 8, 512)(
            *jt, jnp.asarray(s["ext"]), jnp.asarray(s["idx"]))
    else:
        want = jsp.make_elided_hits(V, halo, L_blk, 512)(
            *jt, jnp.asarray(s["tm"]), jnp.asarray(s["tm_idx"]))
    tc.same_hits(got, want)
    plain = hits.window_hits_plain(_t(tab["dflat"]), _t(tab["nb_out"]), V,
                                   halo, L_blk, src, idx)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_hits_kernel(lib, kind, shape):
    """K8's stream body (ids, raw bytes, raw int32 past the LUT's end)
    against make_blocked_hits_stream / _raw."""
    tab = tc.tables(1)
    halo, L = SHAPES[shape]
    s = tc.stream(tab, kind, halo, L)
    V = tab["V"]
    got = _hits_two_pass(lib, "ac_dense_hits", B, table=_t(tab["dflat"]),
                         nb_out=_t(tab["nb_out"]),
                         warm_steps=tab["warm_steps"],
                         **_common(s, halo, L, V))
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    if s["lut"] is None:
        want = jhits.make_blocked_hits_stream(V, halo, 4096, B, L)(
            *jt, jnp.asarray(s["ext"]))
    else:
        want = jhits.make_blocked_hits_raw(V, halo, 4096, B, L)(
            *jt, jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["head_ids"]))
    tc.same_hits(got, want)


def test_k2_mode_kernels(lib):
    """K2 in one thread (make_sequential_scan) and over a time-major
    batch (make_blocked_scan)."""
    tab = tc.tables(1)
    V, dflat = tab["V"], _t(tab["dflat"])
    ids = tc.stream(tab, "ids", 0, 40)["ext"]
    out = torch.full((len(ids),), -7, dtype=torch.int32)
    _run(lib, "ac_dense_states", table=dflat, ext=_t(ids), out=out,
         L=len(ids), B=1, V=V, halo=0, split=1, warm_steps=0)
    _, want = jxla.make_sequential_scan(V)(jnp.asarray(tab["dflat"]),
                                          jnp.asarray(ids), jnp.int32(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    tm = tc.batch(tab, "ids", 37, n_docs=5)["tm"]
    out = torch.full(tm.shape, -7, dtype=torch.int32)
    _run(lib, "ac_dense_states_tm", table=dflat, ext=_t(tm), out=out,
         L=tm.shape[0], B=tm.shape[1], V=V, halo=0, doc_len=tm.shape[0],
         n_docs=tm.shape[1], warm_steps=tab["warm_steps"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jxla.make_blocked_scan(V)(jnp.asarray(tab["dflat"]),
                                  jnp.asarray(tm))))


# -- K9, K10, K11 -------------------------------------------------------------

def _two_tables(tab):
    """The packed table's two-table form, delta_k and cnt_k."""
    packed, cb = tab["packed"], tab["count_bits"]
    return ((packed >> cb).astype(np.int32),
            (packed & ((1 << cb) - 1)).astype(np.int32))


def _planes(tab, max_states=None):
    """The JAX-layout planes (the plain versions' input) and the launch
    fields of K10/K11 over their ``planes_t``."""
    t = tab["machine"].compile()
    planes, cb, n_planes, S_pad = scan_mxu.build_planes(
        t.delta, t.nb_outputs, max_states=max_states)
    fields = scan_mxu.mxu_fields(_t(planes), t.vocab_size, cb, n_planes,
                                 scan_mxu.transpose_planes(
                                     _t(planes), t.vocab_size, n_planes))
    fields.pop("V")
    return planes, fields


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_count_2t_kernel(lib, k, kind, shape):
    """K9's stream body (ids, raw) against its plain version, K3's count
    of the same table packed, and the JAX two-table stream count."""
    tab = tc.tables(k)
    halo_steps = -(-SHAPES[shape][0] // k)
    L = 8 * k if shape == "halo" else 2 * k
    s = tc.stream(tab, kind, halo_steps * k, L)
    V = tab["V"]
    dk, ck = _two_tables(tab)
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_count_2t", table=_t(dk), table2=_t(ck), out=out,
         Vk=V ** k, k=k, warm_steps=tab["warm_steps"],
         **_common(s, halo_steps * k, L, V))
    args = (V, k, halo_steps, B, L, _t(s["ext"]), _t(s["lut"]),
            _t(s["head_ids"]))
    want = multistep.stepped_count_2t_plain(_t(dk), _t(ck), *args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    assert torch.equal(want, multistep.stepped_count_plain(
        _t(tab["packed"]), V, k, tab["count_bits"], *args[2:]))
    if kind == "ids":
        jwant = jms.make_stepped_count_unpacked_stream(
            V, k, V ** k, halo_steps, B, L)(
            jnp.asarray(dk), jnp.asarray(ck), jnp.asarray(s["ext"]))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_count_2t_batch_kernel(lib, k):
    """K9's batch body: count_many's [L, B] ids from the root, against the
    JAX package's make_stepped_count_unpacked."""
    tab = tc.tables(k)
    V = tab["V"]
    tm = tc.batch(tab, "ids", 24 * k, n_docs=5)["tm"]
    dk, ck = _two_tables(tab)
    out = torch.full((5,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_count_2t", table=_t(dk), table2=_t(ck), ext=_t(tm),
         out=out, L=tm.shape[0], Vk=V ** k, B=5, V=V, halo=0, k=k,
         doc_len=tm.shape[0], n_docs=5, layout=1,
         warm_steps=tab["warm_steps"])
    want = multistep.stepped_count_many_2t_plain(_t(dk), _t(ck), V, k, _t(tm))
    assert torch.equal(out, want) and int(want.sum()) > 0
    jwant = jms.make_stepped_count_unpacked(V, k, V ** k, 0)(
        jnp.asarray(dk), jnp.asarray(ck), jnp.asarray(tm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("n_streams", [8, 21])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_mxu_count_kernel(lib, kind, shape, n_streams):
    """K10's warp body over streams (ids, raw bytes, raw int32 past the
    LUT's end; 8 streams fill half a warp's 16 rows, 21 a warp and five
    rows of another) against its plain version and make_mxu_count_stream
    / _raw."""
    tab = tc.tables(1)
    halo, L = SHAPES[shape]
    V = tab["V"]
    s = tc.stream(tab, kind, halo, L * n_streams // B + L, seed=n_streams)
    ext = np.ascontiguousarray(s["ext"][:halo + n_streams * L])
    s = dict(s, ext=ext)
    planes, pf = _planes(tab)
    common = dict(_common(s, halo, L, V), B=n_streams)
    out = torch.full((n_streams,), -7, dtype=torch.int32)
    _run(lib, "ac_mxu_count", out=out, **common, **pf)
    want = scan_mxu.mxu_count_plain(_t(planes), V, pf["count_bits_m"],
                                    pf["n_planes"], halo, n_streams, L,
                                    _t(ext), _t(s["lut"]), _t(s["head_ids"]))
    assert torch.equal(out, want) and int(want.sum()) > 0
    assert torch.equal(want, scan_dense.dense_count_plain(
        _t(tab["dflat"]), _t(tab["nb_out"]), V, halo, n_streams, L, _t(ext),
        _t(s["lut"]), _t(s["head_ids"])))
    geo = (V, pf["S_pad"], pf["count_bits_m"], pf["n_planes"], halo,
           n_streams, L)
    if s["lut"] is None:
        jwant = jmxu.make_mxu_count_stream(*geo)(jnp.asarray(planes),
                                                 jnp.asarray(ext))
    else:
        jwant = jmxu.make_mxu_count_raw(*geo)(
            jnp.asarray(planes), jnp.asarray(s["lut"]), jnp.asarray(ext),
            jnp.asarray(s["head_ids"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", tc.KINDS)
def test_mxu_count_many_kernel(lib, kind, c):
    """K10's batch body against mxu_count_core over split_docs_layout and
    make_mxu_count_many."""
    tab = tc.tables(1)
    V = tab["V"]
    L, Lp = (61, 24) if c == 3 else (24, 24)
    halo = 5 if c > 1 else 0
    b = tc.batch(tab, kind, L)
    planes, pf = _planes(tab)
    out = torch.full((c * 4,), -7, dtype=torch.int32)
    _run(lib, "ac_mxu_count", out=out, layout=1,
         **_many_common(b, c, L, Lp, halo, V), **pf)
    want = scan_mxu.mxu_count_many_plain(
        _t(planes), V, pf["count_bits_m"], pf["n_planes"], halo, c, Lp,
        _t(b["tm"]), _t(b["lut"]))
    assert torch.equal(out, want) and int(want.sum()) > 0
    jp = jnp.asarray(planes)
    geo = (V, pf["S_pad"], pf["count_bits_m"], pf["n_planes"])
    per_col, per_doc = _jax_many(
        b, c, Lp, halo,
        lambda h, w: jmxu.mxu_count_core(*geo, h, jp, w),
        lambda raw: jmxu.make_mxu_count_many(*geo, halo, c, Lp, raw), (jp,))
    np.testing.assert_array_equal(out.numpy(), per_col)
    np.testing.assert_array_equal(
        out.view(c, -1).sum(dim=0, dtype=torch.int64).numpy(), per_doc)


@pytest.mark.parametrize("form", ["idx", "elided"])
def test_mxu_window_kernel(lib, form):
    """K10's window body over the index list and the elided windows,
    against make_sparse_count_mxu and make_mxu_count_halo."""
    tab = tc.tables(1)
    V, L_blk, halo = tab["V"], 16, 5
    s = tc.sparse(tab, halo, L_blk)
    src, idx, fields = _win_fields(s, form, L_blk)
    planes, pf = _planes(tab)
    out = torch.full((fields["B"],), -7, dtype=torch.int32)
    _run(lib, "ac_mxu_count", out=out, L=L_blk, V=V, halo=halo, layout=2,
         **fields, **pf)
    want = sparse.sparse_count_mxu_plain(
        _t(planes), V, pf["count_bits_m"], pf["n_planes"], halo, L_blk,
        src, idx if form == "idx" else None)
    assert torch.equal(out, want) and int(want.sum()) > 0
    geo = (V, pf["S_pad"], pf["count_bits_m"], pf["n_planes"], halo)
    if form == "idx":
        jwant = jsp.make_sparse_count_mxu(*geo, L_blk, s["nB"], 8)(
            jnp.asarray(planes), jnp.asarray(s["ext"]), jnp.asarray(s["idx"]))
    else:
        jwant = jmxu.make_mxu_count_halo(*geo)(jnp.asarray(planes),
                                               jnp.asarray(s["tm"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("B1", [0, 3, 8])
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_hybrid_count_kernel(lib, k, kind, B1):
    """K11: gather columns [0, B1) and MMA columns [B1, B), one halo of
    halo_steps grams, against its plain version and
    make_hybrid_count_stream / _raw."""
    tab = tc.tables(k)
    V, cb = tab["V"], tab["count_bits"]
    hs = -(-5 // k)
    L = 8 * k
    s = tc.stream(tab, kind, hs * k, L)
    planes, pf = _planes(tab, scan_hybrid.MAX_HYBRID_STATES)
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_hybrid_count", table=_t(tab["packed"]), out=out, Vk=V ** k,
         k=k, count_bits=cb, B1=B1, warm_steps=tab["warm_steps"],
         **_common(s, hs * k, L, V), **pf)
    want = scan_hybrid.hybrid_count_plain(
        _t(tab["packed"]), _t(planes), V, k, cb, hs, pf["n_planes"],
        pf["count_bits_m"], B1, B, L, _t(s["ext"]), _t(s["lut"]),
        _t(s["head_ids"]))
    assert torch.equal(out, want) and int(want.sum()) > 0
    geo = (V, k, V ** k, cb, hs, pf["S_pad"], pf["n_planes"],
           pf["count_bits_m"], B1, B - B1, L)
    jp = (jnp.asarray(tab["packed"]), jnp.asarray(planes))
    if s["lut"] is None:
        jwant = jhybrid.make_hybrid_count_stream(*geo)(*jp,
                                                      jnp.asarray(s["ext"]))
    else:
        jwant = jhybrid.make_hybrid_count_raw(*geo)(
            *jp, jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["head_ids"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))


# -- K10, K11: rows per warp, key tiles, plane counts, planes_t ---------------


def _header_rows(name):
    """A rows-per-warp constant of csrc/ac_scan.cuh, as the g++ build and
    the card's take it."""
    with open(os.path.join(build.CSRC_DIR, "ac_scan.cuh")) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


K10_ROWS = _header_rows("AC_K10_ROWS")
K11_ROWS = _header_rows("AC_K11_ROWS")


@pytest.mark.parametrize("form", ["stream", "batch", "window"])
def test_mxu_rows_kernel(lib, form):
    """K10's body at its rows per warp over each layout, column counts
    that R does not divide (21 streams, 12 batch columns, 13 windows),
    against the JAX package's make_mxu_count_raw, make_mxu_count_many and
    make_sparse_count_mxu."""
    tab = tc.tables(1)
    V = tab["V"]
    planes, pf = _planes(tab)
    geo = (V, pf["S_pad"], pf["count_bits_m"], pf["n_planes"])
    jp = jnp.asarray(planes)
    if form == "stream":
        halo, L, n = 5, 24, 21
        s = tc.stream(tab, "raw_u8", halo, L * n // B + L, seed=K10_ROWS)
        ext = np.ascontiguousarray(s["ext"][:halo + n * L])
        out = torch.full((n,), -7, dtype=torch.int32)
        _run(lib, "ac_mxu_count", out=out,
             **dict(_common(dict(s, ext=ext), halo, L, V), B=n), **pf)
        want = jmxu.make_mxu_count_raw(*geo, halo, n, L)(
            jp, jnp.asarray(s["lut"]), jnp.asarray(ext),
            jnp.asarray(s["head_ids"]))
    elif form == "batch":
        c, (L, Lp), halo = 3, (61, 24), 5
        b = tc.batch(tab, "raw_i32", L, seed=K10_ROWS)
        n = c * b["tm"].shape[1]
        out = torch.full((n,), -7, dtype=torch.int32)
        _run(lib, "ac_mxu_count", out=out, layout=1,
             **_many_common(b, c, L, Lp, halo, V), **pf)
        want = jmxu.make_mxu_count_many(*geo, halo, c, Lp, True)(
            jp, jnp.asarray(b["lut"]), jnp.asarray(b["tm"]))
        out = out.view(c, -1).sum(dim=0, dtype=torch.int64)
    else:
        L_blk, halo = 16, 5
        s = tc.sparse(tab, halo, L_blk)
        n = 13   # the index list cycled: live windows in the last warp too
        s = dict(s, idx=np.resize(s["idx"], n))
        _, _, fields = _win_fields(s, "idx", L_blk)
        out = torch.full((n,), -7, dtype=torch.int32)
        _run(lib, "ac_mxu_count", out=out, L=L_blk, V=V, halo=halo, layout=2,
             **fields, **pf)
        want = jsp.make_sparse_count_mxu(*geo, halo, L_blk, s["nB"], n)(
            jp, jnp.asarray(s["ext"]), jnp.asarray(s["idx"]))
    assert n % K10_ROWS
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert int(out.sum()) > 0


def _tile_machine(seed=5, n=90):
    """A seeded machine of n keywords of 3-8 letters over "abcd": enough
    states (S * V over 16 tiles of 32 keys) for 16 rows in 16 key tiles."""
    rng = random.Random(seed)
    m = Machine()
    for _ in range(n):
        m.insert_keyword(bytes(rng.choice(b"abcd")
                               for _ in range(rng.randint(3, 8))))
    return m


def _small_machine():
    m = Machine()
    for w in (b"ab", b"bca", b"cab", b"dd", b"abd", b"cc", b"bd"):
        m.insert_keyword(w)
    return m


def _hand_planes(t, n_planes, S_pad):
    """build_planes' packing of tables t at S_pad states and the count
    bits that give n_planes digit planes (1-4; build_planes' own choice
    gives 2-4): (planes, count_bits)."""
    S, V = t.delta.shape
    cb = 7 * n_planes - (S_pad - 1).bit_length()
    assert cb >= max(1, int(t.nb_outputs.max()).bit_length())
    packed = (t.delta.astype(np.int64) << cb) | t.nb_outputs[t.delta]
    planes = np.zeros((S_pad, n_planes * V), np.int8)
    for p in range(n_planes):
        planes[:S, p * V:(p + 1) * V] = (packed >> (7 * p)) & 127
    return planes, cb


def _paths(delta):
    """A shortest letter-id path from the root to every state (BFS over
    the dense table)."""
    paths = {0: []}
    frontier = [0]
    while frontier:
        nxt = []
        for s in frontier:
            for c in range(delta.shape[1]):
                d = int(delta[s, c])
                if d not in paths:
                    paths[d] = paths[s] + [c]
                    nxt.append(d)
        frontier = nxt
    return paths


def _key_tiles(delta, rows, R):
    """The most distinct 32-key tiles among one warp's R rows at one step,
    and every key: each row (its ids, halo rows first) walked through the
    table."""
    V = delta.shape[1]
    states = np.zeros(len(rows), np.int64)
    most, keys = 0, set()
    for t in range(len(rows[0])):
        c = np.array([r[t] for r in rows])
        key = states * V + c
        for w in range(0, len(rows), R):
            most = max(most, len(set((key[w:w + R] >> 5).tolist())))
        keys |= set(key.tolist())
        states = delta[states, c]
    return most, keys


def _mxu_bodies(lib, n, **fields):
    """K10's body (K10_ROWS rows a warp) and K11's MMA half (K11_ROWS;
    B1 = 0, every column an MMA column) over the same stream-layout launch
    fields; asserts they agree and returns the totals."""
    outs = []
    for name, extra in (("ac_mxu_count", {}), ("ac_hybrid_count",
                                               dict(B1=0))):
        out = torch.full((n,), -7, dtype=torch.int32)
        _run(lib, name, out=out, B=n, layout=0, **fields, **extra)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    return outs[0]


def _k10_rows(lib, t, planes, cb, n_planes, rows, halo):
    """K10's and K11's MMA stream bodies over id rows (halo + L ids each,
    chained as the stream layout reads them), held against K10's plain
    version, the dense count and the JAX package's make_mxu_count_stream;
    returns the totals."""
    V = t.delta.shape[1]
    n, L = len(rows), len(rows[0]) - halo
    ext = np.asarray(rows[0][:halo] + sum((list(r[halo:]) for r in rows), []),
                     np.int32)
    pt = _t(planes)
    fields = scan_mxu.mxu_fields(pt, V, cb, n_planes,
                                 scan_mxu.transpose_planes(pt, V, n_planes))
    out = _mxu_bodies(lib, n, ext=_t(ext), L=L, halo=halo, **fields)
    assert torch.equal(out, scan_mxu.mxu_count_plain(pt, V, cb, n_planes,
                                                     halo, n, L, _t(ext)))
    dflat = _t(np.ascontiguousarray(t.delta, np.int32).ravel())
    nb = _t(np.asarray(t.nb_outputs, np.int32))
    assert torch.equal(out, scan_dense.dense_count_plain(dflat, nb, V, halo,
                                                         n, L, _t(ext)))
    jwant = jmxu.make_mxu_count_stream(V, planes.shape[0], cb, n_planes,
                                       halo, n, L)(jnp.asarray(planes),
                                                   jnp.asarray(ext))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))
    return out


def _chained(rows, halo):
    """Id rows whose halos are the stream layout's: row r's first halo ids
    are row r-1's last (row 0 keeps its own)."""
    out = [list(rows[0])]
    for r in rows[1:]:
        out.append(out[-1][-halo:] + list(r[halo:]) if halo else list(r))
    return out


@pytest.mark.parametrize("case", ["distinct", "same", "last_tile"])
def test_mxu_key_tiles_kernel(lib, case):
    """K10's and K11's MMA bodies over 16 rows that fall, at one step, in
    16 distinct 32-key tiles (each K10 warp's rows all in distinct tiles),
    whose keys share one tile at every step, and where a key falls in
    planes_t's last tile (S_pad = S, the last state read with the last
    letter); then 13 of the rows, dead rows past B in K10's last warp."""
    m = _tile_machine()
    if case == "last_tile":
        n = 1
        while m.compile().n_states % 32:
            m.insert_keyword(b"d" * n)
            n += 1
    t = m.compile()
    delta = np.asarray(t.delta)
    S, V = delta.shape
    S_pad = -(-S // 32) * 32
    planes, cb = _hand_planes(t, 3, S_pad)
    paths = _paths(delta)
    rng = np.random.default_rng(7)
    halo, D = 4, max(len(p) for p in paths.values()) + 1  # >= one OOV
    tail = [list(rng.integers(0, V, 30)) for _ in range(16)]
    if case == "same":
        tail[0][-halo:] = [0] * halo
        rows = [[0] * halo + tail[0]] * 16
    else:
        if case == "distinct":
            seen, picks = set(), []
            for s in sorted(paths, key=lambda s: -s):
                if (s * V + 1) >> 5 not in seen:
                    seen.add((s * V + 1) >> 5)
                    picks.append(s)
            picks = picks[:16]
            nxt = [1] * 16
        else:
            picks = [S - 1] * 16
            nxt = [V - 1] * 16
        assert len(picks) == 16
        rows = [[0] * halo + [0] * (D - len(paths[s])) + paths[s] + [c]
                + tail[i] for i, (s, c) in enumerate(zip(picks, nxt))]
    rows = _chained(rows, halo)
    most, keys = _key_tiles(delta, rows, K10_ROWS)
    if case == "distinct":
        assert _key_tiles(delta, rows, 16)[0] == 16 and most == K10_ROWS
    elif case == "same":
        assert most == 1
    else:
        assert max(keys) == S_pad * V - 1
    totals = _k10_rows(lib, t, planes, cb, 3, rows, halo)
    assert int(totals.sum()) > 0
    assert 13 % K10_ROWS
    sub = _k10_rows(lib, t, planes, cb, 3, rows[:13], halo)
    assert torch.equal(sub, totals[:13])


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
def test_mxu_plane_count_kernel(lib, n_planes):
    """K10's and K11's MMA bodies with 1 to 4 digit planes (count bits
    chosen so, over a machine of at most 32 states and 3 matches a state
    at S_pad 32), against the JAX package's make_mxu_count_stream and the
    dense count."""
    t = _small_machine().compile()
    assert t.n_states <= 32 and int(t.nb_outputs.max()) <= 3
    planes, cb = _hand_planes(t, n_planes, 32)
    V, halo = t.delta.shape[1], 3
    rng = np.random.default_rng(n_planes)
    ids = _chained([list(rng.integers(0, V, halo + 40)) for _ in range(11)],
                   halo)
    out = _k10_rows(lib, t, planes, cb, n_planes, ids, halo)
    assert int(out.sum()) > 0


def test_mxu_byte_machine_kernel(lib):
    """K10's and K11's MMA bodies over a ByteMachine (V = 257) at S_pad
    512, its planes_t 2 x 512 x 257 bytes, raw bytes through the byte LUT,
    against the JAX package's make_mxu_count_raw."""
    from aho_corasick_1975_tpu_torch import ByteMachine
    rng = np.random.default_rng(11)
    m = ByteMachine()
    alphabet = rng.choice(256, 40, replace=False).astype(np.uint8)
    words = []
    while m.compile().n_states < 400:
        w = bytes(rng.choice(alphabet, int(rng.integers(3, 9))))
        words.append(w)
        m.insert_keyword(w)
    t = m.compile()
    planes, cb, n_planes, S_pad = scan_mxu.build_planes(t.delta,
                                                        t.nb_outputs)
    V = t.vocab_size
    assert (V, S_pad) == (257, 512)
    halo, L, n = 8, 64, 19
    text = b"".join(words[int(i)] + bytes(rng.choice(alphabet, 3))
                    for i in rng.integers(0, len(words), 400))
    raw = np.frombuffer(text[:halo + n * L], np.uint8).copy()
    lut = (np.arange(256) + 1).astype(np.int32)
    head = rng.integers(1, V, halo).astype(np.int32)
    pt = _t(planes)
    fields = scan_mxu.mxu_fields(pt, V, cb, n_planes,
                                 scan_mxu.transpose_planes(pt, V, n_planes))
    out = _mxu_bodies(lib, n, ext=_t(raw), lut=_t(lut), head_ids=_t(head),
                      L=L, halo=halo, ext_u8=1, n_lut=256, **fields)
    jwant = jmxu.make_mxu_count_raw(V, S_pad, cb, n_planes, halo, n, L)(
        jnp.asarray(planes), jnp.asarray(lut), jnp.asarray(raw),
        jnp.asarray(head))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))
    assert int(out.sum()) > 0


@pytest.mark.parametrize("k", [2, 3])
def test_hybrid_rows_kernel(lib, k):
    """K11 at its rows per warp, 5 MMA columns (B1 = 3 of 8), raw bytes,
    against make_hybrid_count_raw."""
    tab = tc.tables(k)
    V, cb = tab["V"], tab["count_bits"]
    hs, L, B1 = -(-5 // k), 8 * k, 3
    s = tc.stream(tab, "raw_u8", hs * k, L, seed=K11_ROWS)
    planes, pf = _planes(tab, scan_hybrid.MAX_HYBRID_STATES)
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_hybrid_count", table=_t(tab["packed"]), out=out, Vk=V ** k,
         k=k, count_bits=cb, B1=B1, warm_steps=tab["warm_steps"],
         **_common(s, hs * k, L, V), **pf)
    jwant = jhybrid.make_hybrid_count_raw(
        V, k, V ** k, cb, hs, pf["S_pad"], pf["n_planes"], pf["count_bits_m"],
        B1, B - B1, L)(jnp.asarray(tab["packed"]), jnp.asarray(planes),
                       jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
                       jnp.asarray(s["head_ids"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jwant))
    assert int(out[B1:].sum()) > 0


def test_planes_t_is_the_permute_of_the_planes():
    """planes_t[p, s*V + c] == planes[s, p*V + c] of the JAX package's
    planes, zero past S_pad*V, for build_planes' and hand-made planes."""
    from aho_corasick_1975_tpu_torch import ByteMachine
    bm = ByteMachine()
    for w in (b"\x00\xff", b"abc", b"\xfe\xfe\x01"):
        bm.insert_keyword(w)
    cases = []
    for t, max_states in ((tc.machine(0).compile(), None),
                          (_tile_machine().compile(),
                           scan_hybrid.MAX_HYBRID_STATES),
                          (bm.compile(), None)):
        planes, _, n_planes, S_pad = jmxu.build_planes(
            t.delta, t.nb_outputs, max_states=max_states)
        cases.append((np.asarray(planes), n_planes, t.delta.shape[1]))
    t = _small_machine().compile()
    for n_planes in (1, 4):
        cases.append((_hand_planes(t, n_planes, 32)[0], n_planes,
                      t.delta.shape[1]))
    for planes, n_planes, V in cases:
        S_pad = planes.shape[0]
        got = scan_mxu.transpose_planes(_t(planes), V, n_planes).numpy()
        K = scan_mxu.key_stride(S_pad, V)
        assert got.shape == (n_planes, K) and K % 32 == 0
        want = np.einsum("spc->psc", planes.reshape(S_pad, n_planes, V))
        np.testing.assert_array_equal(got[:, :S_pad * V],
                                      want.reshape(n_planes, S_pad * V))
        assert not got[:, S_pad * V:].any()


@pytest.mark.parametrize("bad", ["none", "shape", "dtype", "device"])
def test_mxu_fields_refuse_a_launch_without_planes_t(bad):
    """A launch's fields need the planes' own planes_t: missing, of
    another shape or dtype, or on another device, they raise, so that no
    launch reads planes laid out otherwise."""
    t = tc.machine(0).compile()
    planes, cb, n_planes, _ = scan_mxu.build_planes(t.delta, t.nb_outputs)
    pt, V = _t(planes), t.vocab_size
    good = scan_mxu.transpose_planes(pt, V, n_planes)
    assert scan_mxu.mxu_fields(pt, V, cb, n_planes, good)["planes_t"] is good
    wrong = {"none": None, "shape": good[:, :-32].contiguous(),
             "dtype": good.to(torch.int32), "device": good.to("meta")}[bad]
    with pytest.raises(ValueError, match="planes_t"):
        scan_mxu.mxu_fields(pt, V, cb, n_planes, wrong)


def _assoc_launch(lib, delta, ids, chunk, tile):
    """K12's three phases through the g++ build at a chunk and tile size:
    (states, compose [B + n_tiles, S], starts [B])."""
    S, V = delta.shape
    n_chunks = -(-ids.numel() // chunk)
    n_tiles = -(-n_chunks // tile)
    out = torch.full((ids.numel(),), -7, dtype=torch.int32)
    compose = torch.full((n_chunks + n_tiles, S), -7, dtype=torch.int32)
    starts = torch.full((n_chunks,), -7, dtype=torch.int32)
    _run(lib, "ac_assoc_scan", table=delta, ext=ids, out=out, L=chunk,
         B=n_chunks, V=V, doc_len=ids.numel(), n_states=S, tile=tile,
         compose=compose, starts=starts)
    return out, compose, starts


def _assoc_consistent(out, compose, starts, chunk, tile):
    """Each chunk's start state is the state before its first id (the
    root for the first), and each tile's function is its chunks'
    composed: the phases hold together, not only their last output."""
    B = starts.numel()
    assert int(starts[0]) == 0
    assert torch.equal(starts[1:], out[chunk - 1:(B - 1) * chunk:chunk])
    F, H = compose[:B].long(), compose[B:].long()
    for i in range(H.shape[0]):
        s = torch.arange(compose.shape[1])
        for c in range(i * tile, min((i + 1) * tile, B)):
            s = F[c][s]
        assert torch.equal(H[i], s)


@pytest.mark.parametrize("tile", [1, 3, 32])
@pytest.mark.parametrize("chunk", [1, 7, 64, 5000])
def test_assoc_scan_kernel(lib, chunk, tile):
    """K12's three phases (each chunk's function at every state, each
    tile's, each chunk re-run from the start its tile's and the tiles'
    functions give) against the JAX package's make_assoc_scan and the
    plain version, at chunks that do not divide T (a last chunk short),
    a chunk longer than T, and tiles of 1, 3 (a last tile short) and 32
    chunks (more than there are)."""
    from aho_corasick_1975_tpu.ops.scan_assoc import make_assoc_scan
    from aho_corasick_1975_tpu_torch.ops import scan_assoc
    tab = tc.tables(1)
    t = tab["machine"].compile()
    V = t.vocab_size
    ids = np.random.default_rng(5).integers(0, V, 999).astype(np.int32)
    delta = _t(np.ascontiguousarray(t.delta, np.int32))
    out, compose, starts = _assoc_launch(lib, delta, _t(ids), chunk, tile)
    want = np.asarray(make_assoc_scan(V)(jnp.asarray(t.delta),
                                         jnp.asarray(ids)))
    np.testing.assert_array_equal(out.numpy(), want)
    assert torch.equal(out, scan_assoc.assoc_scan_plain(delta, _t(ids)))
    _assoc_consistent(out, compose, starts, chunk, tile)


@pytest.mark.parametrize("T", [1, 4000, 40000])
def test_assoc_scan_wrapper_geometry(lib, T):
    """The wrapper's own launch (``scan_assoc.launch_fields``: chunks of
    CHUNK ids, tiles of ``tile_for`` chunks, a last chunk and tile short)
    through the g++ build equals the plain version and the one-thread scan,
    and its tiles keep both chains short: a tile at most sqrt(B) rounded
    up to a power of two (at least a warp), as many tiles."""
    from aho_corasick_1975_tpu_torch.ops import scan_assoc
    t = tc.tables(1)["machine"].compile()
    delta = _t(np.ascontiguousarray(t.delta, np.int32))
    ids = _t(np.random.default_rng(T).integers(
        0, t.vocab_size, T).astype(np.int32))
    out = torch.full((T,), -7, dtype=torch.int32)
    fields = scan_assoc.launch_fields(delta, ids, out)
    n_tiles = -(-fields["B"] // fields["tile"])
    assert fields["B"] == -(-T // scan_assoc.CHUNK)
    assert fields["compose"].shape == (fields["B"] + n_tiles, t.n_states)
    assert 32 <= fields["tile"] < max(64, 2 * fields["B"] ** 0.5 + 1)
    assert n_tiles <= fields["tile"]
    _run(lib, "ac_assoc_scan", **fields)
    assert torch.equal(out, scan_assoc.assoc_scan_plain(delta, ids))
    assert torch.equal(out, scan_dense.sequential_states_plain(
        delta.reshape(-1), t.vocab_size, ids))
    _assoc_consistent(out, fields["compose"], fields["starts"],
                      fields["L"], fields["tile"])


@pytest.mark.parametrize("case", ["one_id", "whole_chunks", "wide_table"])
def test_assoc_scan_kernel_edges(lib, case):
    """K12 at T = 1, at T a multiple of the chunk (every chunk whole), and
    over a random table of 1,000 states and 200 letters, whose 400 KB of
    uint16 rows pass a block's shared memory, so the phases read it in
    place: equal to the plain version and the one-thread scan. A tile of
    0 or past 1,024 chunks, or a chunk past what a block stages, fails the
    launch."""
    from aho_corasick_1975_tpu_torch.ops import scan_assoc
    if case == "wide_table":
        rng = np.random.default_rng(9)
        delta = _t(rng.integers(0, 1000, (1000, 200)).astype(np.int32))
        ids = _t(rng.integers(0, 200, 777).astype(np.int32))
        chunk, tile = 16, 4
    else:
        t = tc.tables(1)["machine"].compile()
        delta = _t(np.ascontiguousarray(t.delta, np.int32))
        n = 1 if case == "one_id" else 8 * 24
        ids = _t(np.random.default_rng(6).integers(
            0, t.vocab_size, n).astype(np.int32))
        chunk, tile = (64, 32) if case == "one_id" else (8, 4)
    out, compose, starts = _assoc_launch(lib, delta, ids, chunk, tile)
    assert torch.equal(out, scan_assoc.assoc_scan_plain(delta, ids))
    assert torch.equal(out, scan_dense.sequential_states_plain(
        delta.reshape(-1), delta.shape[1], ids))
    _assoc_consistent(out, compose, starts, chunk, tile)
    for bad in (dict(tile=0), dict(tile=1025), dict(L=16385)):
        fields = dict(table=delta, ext=ids, out=out, L=chunk, B=1,
                      V=delta.shape[1], doc_len=ids.numel(),
                      n_states=delta.shape[0], tile=tile, compose=compose,
                      starts=starts)
        args = build.scan_args(**dict(fields, **bad))
        assert lib.ac_assoc_scan(ctypes.byref(args), None) != 0


# -- K3, K5, K9, K11: sub-streams ----------------------------------------------

SPLITS = [1, 2, 4, 8, 16, 32]
# (kernel, input kind, halo in symbols or None for the ceil(5/k) grams of
# the cases above, body grams a stream); a halo of 2 symbols is shorter
# than every warm-up (max_depth 6: 5 symbols), and a body of 2 grams is too
# short for most splits
SPLIT_CASES = {
    "k3_raw_u8": ("k3", "raw_u8", 2, 40),
    "k3_raw_i32": ("k3", "raw_i32", None, 37),
    "k3_ids_halo0": ("k3", "ids", 0, 40),
    "k3_short": ("k3", "raw_u8", None, 2),
    "k5_c1": ("k5", "raw_u8", 0, 40),
    "k5_c3": ("k5", "raw_i32", None, 40),
    "k9_stream": ("k9", "raw_u8", 2, 40),
    "k9_batch": ("k9_batch", "ids", 0, 37),
    "k11_gather": ("k11", "raw_u8", 2, 40),
    "k11_mixed": ("k11_mixed", "ids", None, 40),
}


@pytest.fixture(scope="module")
def split_refs():
    """The references of SPLIT_CASES by (case, k), made once per module:
    the sub-stream splits of a case all hold against one."""
    refs: dict = {}

    def get(case, k):
        if (case, k) not in refs:
            refs[case, k] = _split_ref(case, k)
        return refs[case, k]
    return get


def _split_ref(case, k):
    """(entry point, launch fields, the plain version's totals, the JAX
    package's per-column totals) of one SPLIT_CASES case."""
    kernel, kind, halo, n_body = SPLIT_CASES[case]
    tab = tc.tables(k)
    V, cb, Vk = tab["V"], tab["count_bits"], tab["V"] ** k
    hs = -(-5 // k) if halo is None else -(-halo // k)
    L = n_body * k
    packed, jpacked = _t(tab["packed"]), jnp.asarray(tab["packed"])
    base = dict(Vk=Vk, k=k, count_bits=cb, warm_steps=tab["warm_steps"])
    if kernel in ("k5", "k9_batch"):
        c = 3 if case == "k5_c3" else 1
        Lp = L
        Ld = 3 * L - k if c == 3 else L
        b = tc.batch(tab, kind, Ld, n_docs=5)
        hs = hs if c > 1 else 0
        fields = dict(base, **_many_common(b, c, Ld, Lp, hs * k, V))
        if kernel == "k9_batch":
            dk, ck = _two_tables(tab)
            fields.update(table=_t(dk), table2=_t(ck), layout=1)
            plain = multistep.stepped_count_many_2t_plain(
                _t(dk), _t(ck), V, k, _t(b["tm"]))
            jwant = np.asarray(jms.make_stepped_count_unpacked(V, k, Vk, 0)(
                jnp.asarray(dk), jnp.asarray(ck), jnp.asarray(b["tm"])))
            return "ac_stepped_count_2t", fields, plain, jwant
        fields.update(table=packed)
        plain = multistep.stepped_count_many_plain(
            packed, V, k, cb, hs, c, Lp, _t(b["tm"]), _t(b["lut"]))
        per_col, _ = _jax_many(
            b, c, Lp, hs * k,
            lambda h, w: jms.stepped_count_core(V, k, Vk, cb, h // k, jpacked,
                                                w),
            lambda raw: jms.make_stepped_count_many(V, k, Vk, cb, hs, c, Lp,
                                                    raw),
            (jpacked,))
        return "ac_stepped_count_many", fields, plain, per_col
    s = tc.stream(tab, kind, hs * k, L, seed=n_body)
    fields = dict(base, **_common(s, hs * k, L, V))
    args = (V, k, hs, B, L, _t(s["ext"]), _t(s["lut"]), _t(s["head_ids"]))
    if s["lut"] is None:
        jk3 = jms.make_stepped_count_stream(V, k, Vk, cb, hs, B, L)(
            jpacked, jnp.asarray(s["ext"]))
    else:
        jk3 = jms.make_stepped_count_raw(V, k, Vk, cb, hs, B, L)(
            jpacked, jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["head_ids"]))
    plain = multistep.stepped_count_plain(packed, V, k, cb, *args[2:])
    if kernel == "k9":
        dk, ck = _two_tables(tab)
        fields.update(table=_t(dk), table2=_t(ck))
        assert torch.equal(plain, multistep.stepped_count_2t_plain(
            _t(dk), _t(ck), *args))
        return "ac_stepped_count_2t", fields, plain, np.asarray(jk3)
    fields.update(table=packed)
    if kernel == "k3":
        return "ac_stepped_count", fields, plain, np.asarray(jk3)
    # K11: every column a gather column, or 3 gather and 5 MMA columns
    B1 = B if kernel == "k11" else 3
    planes, pf = _planes(tab, scan_hybrid.MAX_HYBRID_STATES)
    fields.update(B1=B1, **pf)
    plain = scan_hybrid.hybrid_count_plain(
        packed, _t(planes), V, k, cb, hs, pf["n_planes"], pf["count_bits_m"],
        B1, *args[3:])
    geo = (V, k, Vk, cb, hs, pf["S_pad"], pf["n_planes"], pf["count_bits_m"],
           B1, B - B1, L)
    jp = (jpacked, jnp.asarray(planes))
    if s["lut"] is None:
        jwant = jhybrid.make_hybrid_count_stream(*geo)(*jp,
                                                      jnp.asarray(s["ext"]))
    else:
        jwant = jhybrid.make_hybrid_count_raw(*geo)(
            *jp, jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["head_ids"]))
    return "ac_hybrid_count", fields, plain, np.asarray(jwant)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_split_kernels(lib, split_refs, k, case, split):
    """K3 (raw bytes, raw int32, ids at halo 0, a stream of 2 grams), K5
    (c = 1 with halo 0, c = 3), K9's stream and batch forms and K11 (every
    column a gather column, and a mixed split) with each column forced into
    ``split`` sub-streams (remainders where split does not divide the body;
    empty parts where it passes it), each warmed up over the tables'
    warm_steps, more than the halo: every total exact against the plain
    version and the JAX package, and the library reports the split."""
    name, fields, plain, jwant = split_refs(case, k)
    out = torch.full((plain.numel(),), -7, dtype=torch.int32)
    _run(lib, name, out=out, split=split, **fields)
    assert torch.equal(out, plain) and int(plain.sum()) > 0
    np.testing.assert_array_equal(out.numpy(), jwant)
    assert lib.ac_last_split() == split


def test_stepped_split_warm_up_is_needed(lib, split_refs):
    """The warm-up is what makes the split exact: with no warm-up, the
    same K3 launch at 16 sub-streams a stream loses the matches that
    straddle its sub-streams' starts."""
    name, fields, plain, _ = split_refs("k3_raw_u8", 1)
    assert fields["warm_steps"] == 5
    out = torch.full((plain.numel(),), -7, dtype=torch.int32)
    _run(lib, name, out=out, split=16, **dict(fields, warm_steps=0))
    assert int(out.sum()) < int(plain.sum())


def test_stepped_split_rejects_a_bad_split(lib, split_refs):
    """A forced split that is no power of two up to 32 fails the launch
    (the card's launcher returns cudaErrorInvalidValue), and the wrappers
    refuse it before any launch."""
    name, fields, plain, _ = split_refs("k3_raw_u8", 1)
    out = torch.zeros(plain.numel(), dtype=torch.int32)
    for bad in (3, 64, -2):
        args = build.scan_args(out=out, split=bad, **fields)
        assert getattr(lib, name)(ctypes.byref(args), None) != 0
        with pytest.raises(ValueError, match="split"):
            multistep.split_fields(4, 1, 5, bad)
    with pytest.raises(ValueError, match="warm_steps"):
        multistep.split_fields(4, 1, -1, 0)


# -- K4: sub-streams writing their grams' words ------------------------------

def _emit_ref(k, kind, halo=2, n_body=37):
    """K4's launch fields (warmed up over the tables' emit_warm), the plain
    version's (emit, n_hits, n_live) and the JAX package's (emit [B, L/k],
    n_hits, summed n_live) over B streams of n_body grams behind a halo of
    ``halo`` symbols, rounded up to grams."""
    tab = tc.tables(k)
    V, cb = tab["V"], tab["count_bits"]
    hs = -(-halo // k)
    L = n_body * k
    s = tc.stream(tab, kind, hs * k, L, seed=n_body + k)
    packed = _t(tab["packed"])
    fields = dict(_common(s, hs * k, L, V), table=packed, Vk=V ** k, k=k,
                  count_bits=cb, warm_steps=tab["emit_warm"])
    plain = hits.stepped_emit_plain(packed, V, k, cb, hs, B, L, _t(s["ext"]),
                                    _t(s["lut"]), _t(s["head_ids"]))
    jp = jnp.asarray(tab["packed"])
    if s["lut"] is None:
        jwant = jhits.make_stepped_hits_scan(V, k, V ** k, cb, hs, B, L)(
            jp, jnp.asarray(s["ext"]))
    else:
        jwant = jhits.make_stepped_hits_scan_raw(V, k, V ** k, cb, hs, B, L)(
            jp, jnp.asarray(s["lut"]), jnp.asarray(s["ext"]),
            jnp.asarray(s["head_ids"]))
    return fields, plain, (np.asarray(jwant[0])[hs:].T,
                           np.asarray(jwant[1]), int(jwant[2]))


def _emit_launch(lib, fields, **kw):
    """One K4 launch through the g++ build: (emit, n_hits, n_live)."""
    n_body = fields["L"] // fields["k"]
    outs = (torch.full((B, n_body), -7, dtype=torch.int32),
            torch.full((B,), -7, dtype=torch.int32),
            torch.full((B,), -7, dtype=torch.int32))
    _run(lib, "ac_stepped_emit", out=outs[0], n_hits=outs[1],
         n_live=outs[2], **dict(fields, **kw))
    return outs


@pytest.mark.parametrize("split", [0] + SPLITS)
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_emit_split_kernel(lib, k, kind, split):
    """K4 with each stream forced into ``split`` sub-streams (0: the
    launcher's pick at full occupancy), behind a halo of 2 symbols,
    shorter than the warm-up, over 37 body grams (remainders where split
    does not divide them; empty parts past them), each part writing its
    grams' words in their slots through the staged sector writes: the
    words, n_hits and n_live bit-equal to the plain version and the JAX
    package's make_stepped_hits_scan / _raw, and the library reports the
    split."""
    fields, plain, jwant = _emit_ref(k, kind)
    got = _emit_launch(lib, fields, split=split)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert int(plain[1].sum()) > 0
    np.testing.assert_array_equal(got[0].numpy(), jwant[0])
    np.testing.assert_array_equal(got[1].numpy(), jwant[1])
    assert int(got[2].sum()) == jwant[2]
    assert lib.ac_last_split() == (split or build.pick_split(
        lib, B, 37, fields["halo"] // k, fields["warm_steps"], _slots(2048)))


@pytest.mark.parametrize("kind", ["ids", "raw_u8"])
@pytest.mark.parametrize("k", [2, 3])
def test_stepped_emit_boundary_needs_the_longer_warm_up(lib, k, kind):
    """A dictionary 7 deep (7 = 1 mod k) whose 7-letter keyword ends at the
    last symbol before every sub-stream's first body gram: K4 at 4
    sub-streams a stream, warmed up over ceil(7/k) grams, writes the
    plain version's and the JAX package's words. Over K3's ceil(6/k) it
    cannot reach the keyword's end, so the word of exactly those first
    grams carries a shallower state; its counts still agree."""
    m = Machine()
    for w in (b"abcdefg", b"cde", b"efg", b"bc"):
        m.insert_keyword(w)
    t = m.compile()
    assert t.max_depth == 7
    snap = DeviceSnapshot(t, step_k=1, device="cpu")
    st = jms.build_stepped(t, k, cap_rows=snap.cap)
    V, cb, P, n_body, hs = snap.V, st.count_bits, 4, 24, 1
    L = n_body * k
    lut = m.vocab.byte_lut()
    lut = np.where(lut < V, lut, 0).astype(np.int32)
    rng = np.random.default_rng(k)
    raw = rng.choice(np.frombuffer(b"abcdefgxyz", np.uint8), hs * k + B * L)
    firsts = []
    for b in range(B):
        for p in range(1, P):
            j0 = hs + n_body * p // P
            end = b * L + j0 * k          # window row j0*k of stream b
            raw[end - 7:end] = np.frombuffer(b"abcdefg", np.uint8)
            firsts.append((b, j0 - hs))
    head = rng.integers(1, V, hs * k).astype(np.int32)
    if kind == "ids":
        ext, lut_k, head_k = lut[raw], None, None
    else:
        ext, lut_k, head_k = raw, lut, head
    packed = _t(st.cap_packed)
    fields = dict(_common(dict(ext=ext, lut=lut_k, head_ids=head_k), hs * k,
                          L, V), table=packed, Vk=V ** k, k=k,
                  count_bits=cb, split=P,
                  warm_steps=multistep.emit_warm_steps_for(t, k))
    assert fields["warm_steps"] == -(-7 // k) > multistep.warm_steps_for(t, k)
    plain = hits.stepped_emit_plain(packed, V, k, cb, hs, B, L, _t(ext),
                                    _t(lut_k), _t(head_k))
    jp = jnp.asarray(st.cap_packed)
    if kind == "ids":
        jwant = jhits.make_stepped_hits_scan(V, k, V ** k, cb, hs, B, L)(
            jp, jnp.asarray(ext))
    else:
        jwant = jhits.make_stepped_hits_scan_raw(V, k, V ** k, cb, hs, B, L)(
            jp, jnp.asarray(lut), jnp.asarray(ext), jnp.asarray(head))
    np.testing.assert_array_equal(plain[0].numpy(),
                                  np.asarray(jwant[0])[hs:].T)
    got = _emit_launch(lib, fields)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    short = _emit_launch(lib, fields,
                         warm_steps=multistep.warm_steps_for(t, k))
    differ = sorted(map(tuple, torch.nonzero(short[0] != plain[0]).tolist()))
    assert differ == sorted(firsts)
    assert torch.equal(short[0] & ((1 << cb) - 1), plain[0] & ((1 << cb) - 1))
    assert torch.equal(short[1], plain[1]) and torch.equal(short[2], plain[2])


@pytest.mark.parametrize("case", ["k3_raw_u8", "k4_raw_u8", "k5_c3",
                                  "k9_batch", "k11_mixed", "k1_raw_u8",
                                  "k8_raw_u8", "k8_window", "k2_raw_u8",
                                  "k2_tm", "k6_c3", "k7_idx", "k7_elided"])
def test_stepped_launch_requires_warm_steps(lib, split_refs, dense_refs,
                                            case):
    """A split launch whose fields leave out warm_steps (scan_args sets
    it to -1) fails, at the launcher's pick and at every forced split, and
    writes nothing: no launch counts without the warm-up. K7 dense's and
    K8's launchers also refuse to give a P for such fields."""
    if case == "k4_raw_u8":
        name, (fields, plain, _) = "ac_stepped_emit", _emit_ref(2, "raw_u8")
    elif case in DENSE_CASES:
        name, fields, plain = dense_refs(case)[:3]
    else:
        name, fields, plain, _ = split_refs(case, 2)
    fields = {key: v for key, v in fields.items() if key != "warm_steps"}
    n = plain[0].numel() if isinstance(plain, tuple) else plain.numel()
    keys = (("out", "n_hits", "n_live") if name == "ac_stepped_emit"
            else ("n_hits", "n_live") if name in HITS_ENTRIES else ("out",))
    for split in (0, 1, 16):
        outs = {key: torch.full((n * 32,), -7, dtype=torch.int32)
                for key in keys}
        args = build.scan_args(split=split, **outs, **fields)
        assert args.warm_steps == -1
        assert getattr(lib, name)(ctypes.byref(args), None) != 0
        assert all(bool((o == -7).all()) for o in outs.values())
        if name in build.PICK_ENTRIES:
            P = ctypes.c_int(0)
            assert getattr(lib, f"{name}_split")(ctypes.byref(args),
                                                 ctypes.byref(P)) != 0


def _slots(threads_per_sm, sms=132):
    return [sms * threads_per_sm] * 6


@pytest.mark.parametrize("shape", ["slice", "config3", "slice_k1"])
def test_launcher_split_choice(lib, split_refs, dense_refs, shape):
    """ac_pick_split at the slice's K3 launch (16,384 streams of 1,408 body
    grams, k = 3), config 3's K5 launch (16,384 columns of 8,192 grams,
    k = 1) and the slice's step_k=1 K1/K8 launch (16,384 streams of 4,224
    symbols, warm-up 9): 16 sub-streams at full occupancy (one wave of
    262,144 threads; 32 would take two waves of half the chain), 32 where
    the card holds 1,536 threads an SM (three waves of a quarter of the
    chain beat two of a half and one of a full), above 8 for the batch
    launches only in one wave, and fewer where the warm-up cap bites. The
    host build picks as the card at full occupancy (K3, K1, K2's and
    K8's stream forms, K8's window form, K7 dense's two forms), and K7
    dense's and K8's ``_split`` queries give the P its launch then
    takes."""
    n_body, hs, warm = {"slice": (1408, 3, 3), "config3": (8192, 10, 10),
                        "slice_k1": (4224, 9, 9)}[shape]
    pick = functools.partial(build.pick_split, lib, 16384, n_body, hs, warm)
    assert pick(_slots(2048)) == 16
    # K4's warm-up, a symbol longer (the slice: ceil(10/3) = 4 grams),
    # leaves the pick where it was
    assert build.pick_split(lib, 16384, n_body, hs, warm + 1,
                            _slots(2048)) == 16
    assert pick(_slots(1536)) == 32
    # the batch launches (K5, K9's batch form) hold 1,024 threads an SM
    # at P >= 16 and take it only in one wave: not for 16,384 columns,
    # but for 256 columns of 4,096 grams (count_many of long documents)
    assert pick(_slots(1024), wide_split=8) == 8
    assert build.pick_split(lib, 256, 4096, 0, warm, _slots(1024),
                            wide_split=8) == 32
    # a chain that fills the card alone stays one thread a stream
    assert build.pick_split(lib, 270336, n_body, hs, warm, _slots(2048)) == 1
    # each sub-stream's body at least 4x its warm-up: 1408 / 32 = 44 >= 40
    assert build.pick_split(lib, 64, n_body, hs, n_body // 128,
                            _slots(2048)) == 32
    assert build.pick_split(lib, 64, n_body, hs, n_body // 64 + 1,
                            _slots(2048)) == 8
    # a stream too short for any split
    assert build.pick_split(lib, 64, 3, 0, 1, _slots(2048)) == 1
    if shape == "slice_k1":
        # K1 and K8 with their tables on the SM: one block of 512 an SM
        assert pick(_slots(512)) == 4
        # the hunt's windows (128 symbols, warm-up 8) at most 4 ways; its
        # 65,536 windows fill one block of 512 an SM alone, and split in
        # two at two such blocks an SM, in four at four
        assert build.pick_split(lib, 2048, 128, 8, 8, _slots(512)) == 4
        assert build.pick_split(lib, 65536, 128, 8, 8, _slots(512)) == 1
        assert build.pick_split(lib, 65536, 128, 8, 8, _slots(1024)) == 2
        assert build.pick_split(lib, 65536, 128, 8, 8, _slots(2048)) == 4
        for case in ("k1_raw_u8", "k8_raw_u8", "k8_window", "k2_raw_u8",
                     "k7_idx", "k7_elided"):
            name, fields, plain, _ = dense_refs(case)
            want = build.pick_split(lib, fields["B"], fields["L"],
                                    fields["halo"], fields["warm_steps"],
                                    _slots(2048))
            assert want > 1
            if name in build.PICK_ENTRIES:
                P = ctypes.c_int(0)
                args = build.scan_args(**fields)
                assert getattr(lib, f"{name}_split")(ctypes.byref(args),
                                                     ctypes.byref(P)) == 0
                assert P.value == want
            if name in HITS_ENTRIES:
                got = _hits_two_pass(lib, name, fields["B"], **fields)
                assert torch.equal(got[0], plain[0])
            else:
                out = torch.zeros(plain.numel(), dtype=torch.int32)
                _run(lib, name, out=out, **fields)
                assert torch.equal(out, plain)
            assert lib.ac_last_split() == want
        return
    name, fields, plain, _ = split_refs("k3_raw_u8", 1)
    out = torch.zeros(plain.numel(), dtype=torch.int32)
    _run(lib, name, out=out, **fields)
    assert lib.ac_last_split() == build.pick_split(
        lib, B, 40, 2, fields["warm_steps"], _slots(2048)) == 2
    assert torch.equal(out, plain)


# -- K1, K8: the 1-char sub-streams --------------------------------------------

HITS_ENTRIES = ("ac_dense_hits", "ac_window_hits")
# K2's entry points: states, one per body symbol, not totals
STATE_ENTRIES = ("ac_dense_states", "ac_dense_states_tm")
# (kernel, input kind, halo in symbols, body symbols a stream or batch
# block) at the k = 1 tables (warm-up 5 symbols): a halo of 2, shorter
# than the warm-up, and 0; remainders (37 symbols); a body of 2 symbols,
# too short for most splits; K8's window form over the index list of
# tc.sparse's stream, windows of 64 symbols (L_blk) behind a halo of 5,
# and K7 dense over the same windows, as the index list and elided;
# K2's time-major form over 5 columns of 37 ids from the root; K6 over 4
# documents, whole (c = 1) or in 3 blocks of 24 behind a halo of 5, the
# last block short (61 symbols)
DENSE_CASES = {
    "k1_raw_u8": ("k1", "raw_u8", 2, 40),
    "k1_raw_i32": ("k1", "raw_i32", 5, 37),
    "k1_ids_halo0": ("k1", "ids", 0, 40),
    "k1_short": ("k1", "raw_u8", 5, 2),
    "k8_raw_u8": ("k8", "raw_u8", 2, 40),
    "k8_raw_i32": ("k8", "raw_i32", 5, 37),
    "k8_ids_halo0": ("k8", "ids", 0, 40),
    "k8_short": ("k8", "raw_u8", 5, 2),
    "k8_window": ("k8", "ids", 5, 64),
    "k7_idx": ("k7", "idx", 5, 64),
    "k7_elided": ("k7", "elided", 5, 64),
    "k2_raw_u8": ("k2", "raw_u8", 2, 40),
    "k2_raw_i32": ("k2", "raw_i32", 5, 37),
    "k2_ids_halo0": ("k2", "ids", 0, 40),
    "k2_short": ("k2", "raw_u8", 5, 2),
    "k2_tm": ("k2_tm", "ids", 0, 37),
    "k6_c1": ("k6", "raw_u8", 0, 24),
    "k6_c3": ("k6", "raw_i32", 5, 24),
}
# The 1-char tables: staged as the card stages them on the SM (the
# uint16 copy of ac_dense_stage; tc.tables' real rows fit), or read in
# place as the card's read-only path does
TABLE_PATHS = {"sm": 0, "global": 1}


@pytest.fixture(scope="module")
def dense_refs():
    """The references of DENSE_CASES, made once per module."""
    refs: dict = {}

    def get(case):
        if case not in refs:
            refs[case] = _dense_ref(case)
        return refs[case]
    return get


def _dense_ref(case):
    """(entry point, launch fields, the plain version's output, the JAX
    package's) of one DENSE_CASES case: K1's per-stream totals (and the
    Pallas kernel's sum, in interpret mode, over the same windows); K8's
    (positions, states, n_hits, n_hit_pos); K2's states, stream order or
    [L, B]; K6's totals per batch column (the JAX package's count over
    split_docs_layout); K7 dense's totals per window (make_sparse_count
    over the index list, make_blocked_count over the elided windows)."""
    from aho_corasick_1975_tpu.ops.scan_pallas import make_pallas_blocked_count
    kernel, kind, halo, L = DENSE_CASES[case]
    tab = tc.tables(1)
    V = tab["V"]
    dflat, nb_out = _t(tab["dflat"]), _t(tab["nb_out"])
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    base = dict(table=dflat, nb_out=nb_out, warm_steps=tab["warm_steps"],
                n_states=tab["n_states"])
    if kernel == "k2_tm":
        tm = tc.batch(tab, kind, L, n_docs=5)["tm"]
        fields = dict(base, nb_out=None, ext=_t(tm), L=L, B=5, V=V, halo=0,
                      doc_len=L, n_docs=5)
        plain = scan_dense.blocked_states_plain(dflat, V, _t(tm))
        jwant = jxla.make_blocked_scan(V)(jt[0], jnp.asarray(tm))
        return "ac_dense_states_tm", fields, plain, np.asarray(jwant)
    if kernel == "k6":
        c = 3 if case == "k6_c3" else 1
        Ld = 3 * L - 11 if c == 3 else L
        b = tc.batch(tab, kind, Ld)
        fields = dict(base, **_many_common(b, c, Ld, L, halo, V))
        plain = scan_dense.dense_count_many_plain(dflat, nb_out, V, halo, c,
                                                  L, _t(b["tm"]),
                                                  _t(b["lut"]))
        per_col, _ = _jax_many(
            b, c, L, halo,
            lambda h, w: jxla.blocked_count_core(V, h, *jt, w),
            lambda raw: jxla.make_blocked_count_many(V, halo, c, L, raw), jt)
        return "ac_dense_count_many", fields, plain, per_col
    if kernel == "k7":
        s = tc.sparse(tab, halo, L)
        src, idx, fields = _win_fields(s, kind, L)
        fields.update(base, L=L, V=V, halo=halo)
        plain = sparse.sparse_count_plain(dflat, nb_out, V, halo, L, src,
                                          idx if kind == "idx" else None)
        if kind == "idx":
            jwant = jsp.make_sparse_count(V, halo, L, s["nB"], len(s["idx"]))(
                *jt, jnp.asarray(s["ext"]), jnp.asarray(s["idx"]))
        else:
            jwant = jxla.make_blocked_count(V, halo)(*jt, jnp.asarray(s["tm"]))
        return "ac_sparse_count", fields, plain, np.asarray(jwant)
    if case == "k8_window":
        s = tc.sparse(tab, halo, L)
        src, idx, fields = _win_fields(s, "idx", L)
        fields.update(base, L=L, V=V, halo=halo)
        plain = hits.window_hits_plain(dflat, nb_out, V, halo, L, src, idx)
        jwant = jsp.make_sparse_hits(V, halo, L, s["nB"], len(s["idx"]),
                                     512)(*jt, jnp.asarray(s["ext"]),
                                          jnp.asarray(s["idx"]))
        return "ac_window_hits", fields, plain, jwant
    s = tc.stream(tab, kind, halo, L, seed=L + halo)
    fields = dict(base, **_common(s, halo, L, V))
    args = (V, halo, B, L, _t(s["ext"]), _t(s["lut"]), _t(s["head_ids"]))
    jext = jnp.asarray(s["ext"])
    if kernel == "k2":
        plain = scan_dense.dense_states_plain(dflat, V, *args[1:])
        if s["lut"] is None:
            jwant = jxla.make_blocked_scan_stream(V, halo, B, L)(jt[0], jext)
        else:
            jwant = jxla.make_blocked_scan_raw(V, halo, B, L)(
                jt[0], jnp.asarray(s["lut"]), jext,
                jnp.asarray(s["head_ids"]))
        return ("ac_dense_states", dict(fields, nb_out=None), plain,
                np.asarray(jwant))
    if kernel == "k1":
        plain = scan_dense.dense_count_plain(dflat, nb_out, *args)
        if s["lut"] is None:
            jwant = jxla.make_blocked_count_stream(V, halo, B, L)(*jt, jext)
            win = jxla.window_layout(jext, B, L, halo)
        else:
            jr = (jnp.asarray(s["lut"]), jext, jnp.asarray(s["head_ids"]))
            jwant = jxla.make_blocked_count_raw(V, halo, B, L)(*jt, *jr)
            win = jxla.raw_window(*jr, B, L, halo)
        pallas = make_pallas_blocked_count(V, halo, interpret=True)(*jt, win)
        assert int(pallas) == int(np.asarray(jwant).sum())
        return "ac_dense_count", fields, plain, np.asarray(jwant)
    plain = hits.dense_hits_plain(dflat, nb_out, *args)
    if s["lut"] is None:
        jwant = jhits.make_blocked_hits_stream(V, halo, 4096, B, L)(*jt, jext)
    else:
        jwant = jhits.make_blocked_hits_raw(V, halo, 4096, B, L)(
            *jt, jnp.asarray(s["lut"]), jext, jnp.asarray(s["head_ids"]))
    return "ac_dense_hits", fields, plain, jwant


def _dense_launch(lib, name, fields, split, path, shape=None):
    """One K1, K2 or K6 launch into an output of ``shape``, or K8's two
    passes, through the g++ build at a forced split over one table
    path."""
    fields = dict(fields, split=split, global_table=TABLE_PATHS[path])
    if name in HITS_ENTRIES:
        return _hits_two_pass(lib, name, fields["B"], **fields)
    out = torch.full(shape, -7, dtype=torch.int32)
    _run(lib, name, out=out, **fields)
    return out


@pytest.mark.parametrize("path", sorted(TABLE_PATHS))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_split_kernels(lib, dense_refs, case, split, path):
    """K1, K2 and K8 (stream form: raw bytes, raw int32 past the LUT's end
    with head ids, ids at halo 0, a stream of 2 symbols), K8's window
    form, K7 dense (the index list and the elided windows), K2's
    time-major form and K6 (c = 1, and c = 3 with a halo) with
    each column forced into ``split`` sub-streams, each warmed up over the
    tables' 5 symbols, more than a halo of 2, over the tables staged as on
    the SM and in place (K6 and K2's time-major form read them in place on
    both): K1's and K6's totals, K2's states and K8's
    positions and states element for element, exact against the plain
    version, the one-thread body (the launch at P = 1, one chain from the
    root) and the JAX package (make_blocked_count_stream / _raw and the
    Pallas kernel; make_blocked_scan_stream / _raw, make_blocked_scan;
    make_blocked_count_many's columns; make_blocked_hits_stream / _raw;
    make_sparse_hits; make_sparse_count, make_blocked_count), and the
    library reports the split."""
    name, fields, plain, jwant = dense_refs(case)
    shape = None if name in HITS_ENTRIES else plain.shape
    got = _dense_launch(lib, name, fields, split, path, shape)
    assert lib.ac_last_split() == split
    if name in HITS_ENTRIES:
        for a, b in zip(got[:2], plain[:2]):
            assert torch.equal(a, b)
        assert got[2:] == plain[2:]
        tc.same_hits(got, jwant)
    else:
        assert torch.equal(got, plain) and int(plain.sum()) > 0
        np.testing.assert_array_equal(got.numpy(), jwant)
        if split > 1:
            assert torch.equal(got, _dense_launch(lib, name, fields, 1, path,
                                                  shape))


@pytest.mark.parametrize("case", ["k1_raw_u8", "k8_raw_u8", "k2_raw_u8",
                                  "k2_tm", "k6_c3", "k7_idx", "k7_elided"])
def test_dense_split_warm_up_is_needed(lib, dense_refs, case):
    """The warm-up is what makes the 1-char split exact: with none, the
    same launch at 16 sub-streams a stream or column (over a dictionary 6
    deep) loses the matches that straddle its sub-streams' starts (K1, K6,
    K7 dense; K8 also writes wrong states), and K2 writes wrong states."""
    name, fields, plain, _ = dense_refs(case)
    assert fields["warm_steps"] == 5
    shape = None if name in HITS_ENTRIES else plain.shape
    got = _dense_launch(lib, name, dict(fields, warm_steps=0), 16, "sm",
                        shape)
    if name in HITS_ENTRIES:
        assert got[2] < plain[2]
        assert got[3] != plain[3] or not torch.equal(got[1], plain[1])
    elif name in STATE_ENTRIES:
        assert int((got != plain).sum()) > 0
    else:
        assert int(got.sum()) < int(plain.sum())


@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("form", ["idx", "elided"])
def test_k7_boundary_needs_the_warm_up(lib, form, split):
    """K7 dense at its boundary: the tables' longest keyword (max_depth = 6
    letters) planted so that its last letter is the first counted row of
    every sub-stream past the first, in every live window of tc.sparse's
    stream (windows of 64 symbols behind a halo of 5), as the index list
    and as elided windows. With max_depth - 1 symbols of warm-up each
    window's count equals the plain version's and the JAX package's
    (make_sparse_count, make_blocked_count); with one symbol less every
    sub-stream past the first misses its planted match."""
    tab = tc.tables(1)
    V, halo, L = tab["V"], 5, 64
    kw = max(tc.keywords(), key=len)
    assert len(kw) == tab["warm_steps"] + 1
    s = tc.sparse(tab, halo, L)
    ext = s["ext"].copy()
    planted = 0
    for b in tc.LIVE:
        for p in range(1, split):
            end = b * L + halo + L * p // split    # ext index of row j0
            ext[end - len(kw) + 1:end + 1] = tab["byte_lut"][
                np.frombuffer(kw, np.uint8)]
            planted += 1
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    dflat, nb_out = _t(tab["dflat"]), _t(tab["nb_out"])
    idx = _t(s["idx"])
    if form == "idx":
        src = _t(ext)
        jwant = jsp.make_sparse_count(V, halo, L, s["nB"], len(s["idx"]))(
            *jt, jnp.asarray(ext), jnp.asarray(s["idx"]))
    else:
        src = sparse.window_gather(_t(ext), idx, L, halo).to(
            torch.int32).contiguous()
        jwant = jxla.make_blocked_count(V, halo)(*jt, jnp.asarray(src.numpy()))
    plain = sparse.sparse_count_plain(dflat, nb_out, V, halo, L, src,
                                      idx if form == "idx" else None)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jwant))
    fields = dict(sparse.window_fields(L, src, idx), table=dflat,
                  nb_out=nb_out, L=L, V=V, halo=halo, split=split,
                  n_states=tab["n_states"])
    fields.pop("form")
    outs = []
    for warm in (tab["warm_steps"], tab["warm_steps"] - 1):
        out = torch.full((fields["B"],), -7, dtype=torch.int32)
        _run(lib, "ac_sparse_count", out=out, warm_steps=warm, **fields)
        outs.append(out)
    assert torch.equal(outs[0], plain)
    assert int(outs[1].sum()) <= int(plain.sum()) - planted


# Keywords past 64 bytes (a long domain's length) beside tc's short ones:
# the warm-up and the halo are 69 symbols; streams of 3,072 body symbols,
# 96 a sub-stream at P = 32, so that a keyword planted to end on each
# sub-stream's first row lies within the sub-stream before it
LONG_LENGTHS = (64, 70)
LONG_L = 32 * 96


@pytest.fixture(scope="module")
def long_tables():
    """tc.tables(1)'s fields for tc's keywords and two long ones over the
    same letters, and the long keywords."""
    rng = random.Random(17)
    long_kws = [bytes(rng.choice(b"abcd") for _ in range(n))
                for n in LONG_LENGTHS]
    m = Machine()
    for kw in tc.keywords() + long_kws:
        m.insert_keyword(kw)
    t = m.compile()
    snap = DeviceSnapshot(t, step_k=1, device="cpu")
    lut = m.vocab.byte_lut()
    tab = dict(V=snap.V, dflat=snap.dflat.numpy(), nb_out=snap.nb_out.numpy(),
               n_states=t.n_states, warm_steps=multistep.warm_steps_for(t, 1),
               byte_lut=np.where(lut < snap.V, lut, 0).astype(np.int32))
    assert tab["warm_steps"] == max(LONG_LENGTHS) - 1
    return tab, long_kws, {}


def _long_case(long_tables, kernel, kind, split):
    """(entry point, launch fields, the plain version's output, the JAX
    package's, the planted (row, length)) of one stream of each kind where
    a long keyword is planted to end on the first body row of every
    sub-stream at P = ``split``, stream starts past the first included;
    made once per (kernel, kind, split)."""
    tab, long_kws, cache = long_tables
    key = (kernel, kind, split)
    if key in cache:
        return cache[key]
    V, halo, L = tab["V"], tab["warm_steps"], LONG_L
    s = tc.stream(tab, kind, halo, L, seed=split)
    ext = s["ext"].copy()
    planted = []
    for b in range(tc.B):
        for p in range(split):
            if b == p == 0:
                continue
            row = b * L + L * p // split
            kw = np.frombuffer(long_kws[(b + p) % 2], np.uint8)
            sym = tab["byte_lut"][kw] if kind == "ids" else kw
            ext[halo + row - len(kw) + 1:halo + row + 1] = sym
            planted.append((row, len(kw)))
    s = dict(s, ext=ext)
    dflat, nb_out = _t(tab["dflat"]), _t(tab["nb_out"])
    jt = (jnp.asarray(tab["dflat"]), jnp.asarray(tab["nb_out"]))
    args = (V, halo, tc.B, L, _t(ext), _t(s["lut"]), _t(s["head_ids"]))
    jraw = (() if s["lut"] is None else (jnp.asarray(s["lut"]),)) + (
        jnp.asarray(ext),) + (() if s["lut"] is None
                              else (jnp.asarray(s["head_ids"]),))
    fields = dict(_common(s, halo, L, V), table=dflat,
                  warm_steps=tab["warm_steps"], n_states=tab["n_states"])
    if kernel == "k2":
        plain = scan_dense.dense_states_plain(dflat, *args)
        make = (jxla.make_blocked_scan_stream if s["lut"] is None
                else jxla.make_blocked_scan_raw)
        jwant = np.asarray(make(V, halo, tc.B, L)(jt[0], *jraw))
        out = ("ac_dense_states", fields, plain, jwant, planted)
    else:
        plain = hits.dense_hits_plain(dflat, nb_out, *args)
        make = (jhits.make_blocked_hits_stream if s["lut"] is None
                else jhits.make_blocked_hits_raw)
        jwant = make(V, halo, tc.B * L, tc.B, L)(*jt, *jraw)
        out = ("ac_dense_hits", dict(fields, nb_out=nb_out), plain, jwant,
               planted)
    cache[key] = out
    return out


@pytest.mark.parametrize("path", sorted(TABLE_PATHS))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("kernel", ["k2", "k8"])
def test_long_keywords_across_every_split(lib, long_tables, kernel, kind,
                                          split, path):
    """K2's stream form and K8's, at every P, where keywords of 64 and 70
    bytes end on the first body row of every sub-stream and stream past
    the first (ids, raw bytes, raw int32 past the LUT's end with head
    ids), over the tables staged on the SM and read in place: K2's states
    and K8's positions and states equal the plain version's and the JAX
    package's element for element with the tables' 69 symbols of
    warm-up, and each planted row holds its long keyword's match; with one
    symbol less every sub-stream past a stream's first loses the 70-byte
    keyword's (the 64-byte one needs no more than 63)."""
    name, fields, plain, jwant, planted = _long_case(long_tables, kernel,
                                                     kind, split)
    nb_out = long_tables[0]["nb_out"]
    shape = None if name in HITS_ENTRIES else plain.shape
    got = _dense_launch(lib, name, fields, split, path, shape)
    assert lib.ac_last_split() == split
    if name in HITS_ENTRIES:
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        assert got[2:] == plain[2:]
        tc.same_hits(got, jwant)
        assert {r for r, _ in planted} <= set(got[0].tolist())
    else:
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), jwant)
        assert all(nb_out[int(got[r])] > 0 for r, _ in planted)
    inner = [r for r, n in planted
             if r % fields["L"] and n == max(LONG_LENGTHS)]
    if split == 1:
        assert not inner
        return
    assert inner
    short = _dense_launch(lib, name, dict(fields,
                                          warm_steps=fields["warm_steps"] - 1),
                          split, path, shape)
    if name in HITS_ENTRIES:
        assert short[2] <= plain[2] - len(inner)
    else:
        assert all(int(short[r]) != int(plain[r]) for r in inner)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_k2_staged_state_writes(lib, dense_refs, offset, split):
    """K2's stream form stages its states and writes each whole run of 8
    aligned slots as two 16-byte stores, the rest one by one: an output 0,
    4 and 12 bytes off its 16-byte-aligned allocation (so that every run
    or none is aligned), streams of 37 symbols (runs cut at every offset
    mod 8) in 1, 2 and 4 sub-streams, holds the plain version's states,
    and nothing past them; so does the one-thread form (B = 1, P = 1)."""
    name, fields, plain, _ = dense_refs("k2_raw_i32")
    n = plain.numel()
    buf = torch.full((n + 8,), -7, dtype=torch.int32)
    assert buf.data_ptr() % 16 == 0
    out = buf[offset:offset + n]
    assert out.data_ptr() % 16 == 4 * offset
    _run(lib, name, out=out, **dict(fields, split=split))
    assert torch.equal(out, plain)
    assert bool((buf[:offset] == -7).all() and (buf[offset + n:] == -7).all())
    ids = fields["ext"][:n].to(torch.int32) % fields["V"]
    buf.fill_(-7)
    _run(lib, name, out=out, table=fields["table"], ext=ids, L=n, B=1,
         V=fields["V"], halo=0, n_states=fields["n_states"], split=1,
         warm_steps=0)
    assert torch.equal(out, scan_dense.sequential_states_plain(
        fields["table"], fields["V"], ids))
    assert bool((buf[:offset] == -7).all() and (buf[offset + n:] == -7).all())


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_k8_staged_hit_writes(lib, dense_refs, offset):
    """K8's pass 2 stages its hits and writes each whole run of 8 aligned
    slots as 16-byte stores, the rest one by one: output buffers 0, 4 and
    12 bytes off their 16-byte-aligned allocation (so that every run or
    none is aligned) hold the plain version's positions and states, and
    nothing past them."""
    name, fields, plain, _ = dense_refs("k8_raw_u8")
    got = _hits_two_pass(lib, name, fields["B"], offset=offset,
                         **dict(fields, split=2))
    assert got[0].data_ptr() % 16 == 4 * offset
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("kind", tc.KINDS)
def test_k2_one_chain(lib, kind, offset):
    """K2's one-chain form (a launch of one stream kept at P = 1, as
    scan_states_sequential forces it) walks the window in chunks of
    kSeqChunk ids: one stream of three chunks and a bit, raw bytes and
    raw int32 behind a halo of head ids and ids from the root (the
    sequential scan), into outputs 0, 4 and 12 bytes off 16-byte
    alignment, over the tables staged as on the SM and in place, equals
    the plain version and the JAX package (make_blocked_scan_raw /
    make_sequential_scan), and writes nothing past its states; the
    launcher reports P = 1."""
    chunk = int(re.search(r"kSeqChunk = (\d+);", open(os.path.join(
        build.CSRC_DIR, "ac_scan.cuh")).read()).group(1))
    tab = tc.tables(1)
    V, dflat = tab["V"], _t(tab["dflat"])
    halo = 0 if kind == "ids" else 5
    L = 3 * chunk + 37
    rng = np.random.default_rng(offset)
    s = tc.stream(tab, kind, halo + L, 0, seed=7)   # halo + L symbols
    ext = s["ext"]
    head = None if s["lut"] is None else rng.integers(1, V, halo).astype(
        np.int32)
    args = (V, halo, 1, L, _t(ext), _t(s["lut"]), _t(head))
    plain = scan_dense.dense_states_plain(dflat, *args)
    if s["lut"] is None:
        _, jwant = jxla.make_sequential_scan(V)(jnp.asarray(tab["dflat"]),
                                                jnp.asarray(ext),
                                                jnp.int32(0))
    else:
        jwant = jxla.make_blocked_scan_raw(V, halo, 1, L)(
            jnp.asarray(tab["dflat"]), jnp.asarray(s["lut"]),
            jnp.asarray(ext), jnp.asarray(head))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jwant))
    for path in sorted(TABLE_PATHS):
        buf = torch.full((L + 8,), -7, dtype=torch.int32)
        out = buf[offset:offset + L]
        _run(lib, "ac_dense_states", table=dflat, out=out, warm_steps=0,
             split=1, n_states=tab["n_states"],
             global_table=TABLE_PATHS[path],
             **dict(_common(dict(ext=ext, lut=s["lut"], head_ids=head),
                            halo, L, V), B=1))
        assert lib.ac_last_split() == 1
        assert torch.equal(out, plain)
        assert bool((buf[:offset] == -7).all()
                    and (buf[offset + L:] == -7).all())


@pytest.mark.parametrize("case", ["k1_raw_u8", "k2_raw_u8", "k8_raw_u8"])
def test_dense_launch_reports_its_table_path(lib, dense_refs, case):
    """A 1-char stream launch reports the bytes its tables took on the SM
    (``ac_last_dense_table``, ``build.dense_tables`` on the card): the
    real rows' where they fit, 0 through the read-only path or past
    65,536 states (rows of zeros appended to dflat, which the walk never
    reaches), exact on each path."""
    name, fields, plain, _ = dense_refs(case)
    shape = None if name in HITS_ENTRIES else plain.shape
    S, V = fields["n_states"], fields["V"]
    rows = 2 * S * V + 3 & ~3
    on_sm = rows + (0 if name == "ac_dense_states" else 4 * S)
    wide = torch.zeros((65_537 - S) * V + fields["table"].numel(),
                       dtype=torch.int32)
    wide[:fields["table"].numel()] = fields["table"]
    for path, extra, want in (("sm", {}, on_sm), ("global", {}, 0),
                              ("sm", dict(table=wide, n_states=65_537), 0)):
        got = _dense_launch(lib, name, dict(fields, **extra), 4, path, shape)
        assert lib.ac_last_dense_table() == want, (path, extra.keys())
        if name in HITS_ENTRIES:
            assert all(torch.equal(a, b) for a, b in zip(got[:2], plain[:2]))
        else:
            assert torch.equal(got, plain)


def test_dense_table_staging(lib, dense_refs):
    """The copy on the SM from any table: the real rows (their entries no
    multiple of 4, so a scalar tail follows the 16-byte loads), a table 4
    bytes off 16-byte alignment (scalar loads throughout), and all of
    dflat's rows (the wrapper's default); and in place with n_states unset.
    The wrappers refuse an n_states outside dflat's rows."""
    name, fields, plain, _ = dense_refs("k1_raw_u8")
    dflat = fields["table"]
    S, V = fields["n_states"], fields["V"]
    assert (S * V) % 4 and dflat.data_ptr() % 16 == 0
    buf = torch.zeros(dflat.numel() + 1, dtype=torch.int32)
    buf[1:] = dflat
    for extra in (dict(), dict(table=buf[1:]),
                  dict(n_states=dflat.numel() // V), dict(n_states=0)):
        out = _dense_launch(lib, name, dict(fields, **extra), 4, "sm",
                            plain.shape)
        assert torch.equal(out, plain)
    args = (dflat, fields["nb_out"], V, 2, B, 40, fields["ext"],
            fields["lut"], fields["head_ids"])
    for bad in (0, dflat.numel() // V + 1):
        with pytest.raises(ValueError, match="n_states"):
            scan_dense.dense_count(*args, warm_steps=5, n_states=bad)
