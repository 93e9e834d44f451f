"""The CUDA kernels' per-thread code, run on the CPU.

csrc/ac_scan.cuh holds everything one CUDA thread of K1-K6 computes. The
host shim csrc/ac_scan_host.cpp compiles it with g++ behind the kernels'
own C entry points, so the logic the H100 runs is checked here against the
plain PyTorch versions, with exact equality: k in {1, 2, 3}, a halo longer
than a stream, raw uint8 and int32 inputs with non-zero head_ids. The
count_many bodies (K5, K6) are also held, column by column, against the
JAX package's count over ``split_docs_layout`` and, document by document,
against its ``make_stepped_count_many`` / ``make_blocked_count_many``.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu.ops import scan_xla as jxla
from aho_corasick_1975_tpu_torch.ops import build, hits, multistep, scan_dense

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
         **_common(s, halo, L, V))
    want = scan_dense.dense_count_plain(dflat, nb_out, *plain_args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    states = torch.full((B * L,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_states", table=dflat, out=states,
         **_common(s, halo, L, V))
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
                  count_bits=cb)
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
         n_live=n_live, **common)
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
         count_bits=cb, **_many_common(b, c, L, Lp, hs * k, V))
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
         **_many_common(b, c, L, Lp, halo, V))
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
