"""The port's plain op versions against the JAX package's functions, on the
same tables and the same seeded inputs, with exact integer equality.

K1 (dense count) is checked against the Pallas kernel in interpret mode,
as tests/test_pallas_kernel.py runs it, and against the XLA count; K2
against the XLA state scan; K3 against the packed k-gram count; K4 and the
two refinements against the JAX retrieval phases. Cases cover k in
{1, 2, 3}, a halo longer than a stream, and raw inputs with non-zero
head_ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from aho_corasick_1975_tpu.ops import hits as jhits
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu.ops import scan_xla as jxla
from aho_corasick_1975_tpu.ops.scan_pallas import make_pallas_blocked_count
from aho_corasick_1975_tpu_torch.ops import hits, multistep, scan_dense

B = tc.B
# (halo, L) of the dense scans: the automaton's own halo, and one longer
# than a stream
DENSE_SHAPES = {"halo": (5, 24), "long_halo": (9, 4)}


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _dense_case(kind, shape):
    tab = tc.tables(1)
    halo, L = DENSE_SHAPES[shape]
    return tab, halo, L, tc.stream(tab, kind, halo, L)


def _stepped_case(k, kind, shape, seed=1):
    tab = tc.tables(k)
    halo_steps = -(-DENSE_SHAPES[shape][0] // k)
    L = 8 * k if shape == "halo" else 2 * k
    return tab, halo_steps, L, tc.stream(tab, kind, halo_steps * k, L, seed)


def _jax_window(tab, s, halo, L):
    if s["lut"] is None:
        return jxla.window_layout(_j(s["ext"]), B, L, halo)
    return jxla.raw_window(_j(s["lut"]), _j(s["ext"]), _j(s["head_ids"]), B,
                           L, halo)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tables_match_jax(k):
    """The port's DeviceSnapshot and k-gram packing give the JAX
    snapshot's arrays."""
    from aho_corasick_1975_tpu.models.snapshot import DeviceSnapshot
    tab = tc.tables(k)
    t = tab["machine"].compile()
    js = DeviceSnapshot(t, step_k=1)
    np.testing.assert_array_equal(tab["dflat"], np.asarray(js.dflat))
    np.testing.assert_array_equal(tab["nb_out"], np.asarray(js.nb_out))
    st = jms.build_stepped(t, k, cap_rows=js.cap)
    np.testing.assert_array_equal(tab["packed"], st.cap_packed)
    assert tab["count_bits"] == st.count_bits


@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_count(kind, shape):
    tab, halo, L, s = _dense_case(kind, shape)
    V = tab["V"]
    got = scan_dense.dense_count_plain(
        _t(tab["dflat"]), _t(tab["nb_out"]), V, halo, B, L, _t(s["ext"]),
        _t(s["lut"]), _t(s["head_ids"]))
    assert got.dtype == torch.int32 and got.shape == (B,)
    if s["lut"] is None:
        want = jxla.make_blocked_count_stream(V, halo, B, L)(
            _j(tab["dflat"]), _j(tab["nb_out"]), _j(s["ext"]))
    else:
        want = jxla.make_blocked_count_raw(V, halo, B, L)(
            _j(tab["dflat"]), _j(tab["nb_out"]), _j(s["lut"]), _j(s["ext"]),
            _j(s["head_ids"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0
    # the Pallas kernel, in interpret mode, on the same windows
    pallas = make_pallas_blocked_count(V, halo, interpret=True)(
        _j(tab["dflat"]), _j(tab["nb_out"]), _jax_window(tab, s, halo, L))
    assert int(pallas) == int(got.sum(dtype=torch.int64))


@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_states(kind, shape):
    tab, halo, L, s = _dense_case(kind, shape)
    V = tab["V"]
    got = scan_dense.dense_states_plain(
        _t(tab["dflat"]), V, halo, B, L, _t(s["ext"]), _t(s["lut"]),
        _t(s["head_ids"]))
    if s["lut"] is None:
        want = jxla.make_blocked_scan_stream(V, halo, B, L)(
            _j(tab["dflat"]), _j(s["ext"]))
    else:
        want = jxla.make_blocked_scan_raw(V, halo, B, L)(
            _j(tab["dflat"]), _j(s["lut"]), _j(s["ext"]), _j(s["head_ids"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_count(k, kind, shape):
    tab, hs, L, s = _stepped_case(k, kind, shape)
    V, cb = tab["V"], tab["count_bits"]
    got = multistep.stepped_count_plain(
        _t(tab["packed"]), V, k, cb, hs, B, L, _t(s["ext"]), _t(s["lut"]),
        _t(s["head_ids"]))
    if s["lut"] is None:
        want = jms.make_stepped_count_stream(V, k, V ** k, cb, hs, B, L)(
            _j(tab["packed"]), _j(s["ext"]))
    else:
        want = jms.make_stepped_count_raw(V, k, V ** k, cb, hs, B, L)(
            _j(tab["packed"]), _j(s["lut"]), _j(s["ext"]), _j(s["head_ids"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def _jax_emit(tab, k, hs, L, s):
    V, cb = tab["V"], tab["count_bits"]
    if s["lut"] is None:
        return jhits.make_stepped_hits_scan(V, k, V ** k, cb, hs, B, L)(
            _j(tab["packed"]), _j(s["ext"]))
    return jhits.make_stepped_hits_scan_raw(V, k, V ** k, cb, hs, B, L)(
        _j(tab["packed"]), _j(s["lut"]), _j(s["ext"]), _j(s["head_ids"]))


def _emit(tab, k, hs, L, s):
    return hits.stepped_emit_plain(
        _t(tab["packed"]), tab["V"], k, tab["count_bits"], hs, B, L,
        _t(s["ext"]), _t(s["lut"]), _t(s["head_ids"]))


@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_emit(k, kind, shape):
    tab, hs, L, s = _stepped_case(k, kind, shape)
    emit, n_hits, n_live = _emit(tab, k, hs, L, s)
    j_emit, j_hits, j_live = _jax_emit(tab, k, hs, L, s)
    # JAX: [halo_steps + L/k, B] time-major; port: [B, L/k] body grams
    np.testing.assert_array_equal(emit.numpy(),
                                  np.asarray(j_emit)[hs:].T)
    np.testing.assert_array_equal(n_hits.numpy(), np.asarray(j_hits))
    assert int(n_live.sum()) == int(j_live) > 0


def _sym_at(s, halo_sym):
    body = _t(s["ext"])[halo_sym:]
    if s["lut"] is None:
        return lambda p: body[p].long()
    lut = _t(s["lut"])
    return lambda p: scan_dense.lookup(lut, body[p])


@pytest.mark.parametrize("kind", ["ids", "raw_u8"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("cap", [8, 256])
def test_hits_extract(k, kind, cap):
    """Compaction refinement; cap 8 truncates the live grams exactly as
    the JAX compaction does."""
    tab, hs, L, s = _stepped_case(k, kind, "halo", seed=2)
    V, cb = tab["V"], tab["count_bits"]
    emit, _, _ = _emit(tab, k, hs, L, s)
    out_size = cap * k
    got = hits.hits_extract(V, k, cb, cap, out_size, emit,
                            _sym_at(s, hs * k), _t(tab["dflat"]),
                            _t(tab["nb_out"]))
    j_emit = _jax_emit(tab, k, hs, L, s)[0]
    args = (_j(tab["dflat"]), _j(tab["nb_out"]))
    if s["lut"] is None:
        want = jhits.make_stepped_hits_extract(
            V, k, cb, hs, cap, out_size, B, L)(*args, _j(s["ext"]), j_emit)
    else:
        want = jhits.make_stepped_hits_extract_raw(
            V, k, cb, hs, cap, out_size, B, L)(
                *args, _j(s["lut"]), _j(s["ext"]), j_emit)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2]) > 0


@pytest.mark.parametrize("kind", ["ids", "raw_u8"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("max_hits", [16, 512])
def test_hits_extract_dense(k, kind, max_hits):
    tab, hs, L, s = _stepped_case(k, kind, "halo", seed=3)
    V, cb, cb1 = tab["V"], tab["count_bits"], tab["cb1"]
    emit, _, _ = _emit(tab, k, hs, L, s)
    body = _t(s["ext"])[hs * k:]
    syms = body.long() if s["lut"] is None else scan_dense.lookup(
        _t(s["lut"]), body)
    got = hits.hits_extract_dense(V, k, cb, cb1, max_hits, _t(tab["pk1"]),
                                  emit, syms)
    j_emit = _jax_emit(tab, k, hs, L, s)[0]
    if s["lut"] is None:
        want = jhits.make_stepped_hits_extract_dense(
            V, k, cb, cb1, hs, max_hits, B, L)(
                _j(tab["pk1"]), _j(s["ext"]), j_emit)
    else:
        want = jhits.make_stepped_hits_extract_dense_raw(
            V, k, cb, cb1, hs, max_hits, B, L)(
                _j(tab["pk1"]), _j(s["lut"]), _j(s["ext"]), j_emit)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2]) > 0


def test_wrappers_on_cpu_are_the_plain_versions():
    tab, hs, L, s = _stepped_case(2, "raw_u8", "halo")
    args = (_t(tab["packed"]), tab["V"], 2, tab["count_bits"], hs, B, L,
            _t(s["ext"]), _t(s["lut"]), _t(s["head_ids"]))
    assert torch.equal(multistep.stepped_count(*args),
                       multistep.stepped_count_plain(*args))
    for a, b in zip(hits.stepped_emit(*args), hits.stepped_emit_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["short_ext", "float_ext", "u8_ids",
                                 "no_head", "odd_L", "int64_table"])
def test_wrappers_reject_bad_inputs(bad):
    tab, hs, L, s = _stepped_case(2, "raw_u8", "halo")
    packed, ext = _t(tab["packed"]), _t(s["ext"])
    lut, head = _t(s["lut"]), _t(s["head_ids"])
    kw = dict(V=tab["V"], k=2, count_bits=tab["count_bits"], halo_steps=hs,
              B=B, L=L)
    if bad == "short_ext":
        ext = ext[:-1]
    elif bad == "float_ext":
        ext = ext.float()
    elif bad == "u8_ids":
        lut = head = None
    elif bad == "no_head":
        head = None
    elif bad == "odd_L":
        kw["L"] = L - 1
        ext = ext[:-B]
    else:
        packed = packed.long()
    with pytest.raises(ValueError):
        multistep.stepped_count(packed, ext=ext, lut=lut, head_ids=head, **kw)


def test_count_many_wrappers_on_cpu_are_the_plain_versions():
    tab = tc.tables(2)
    b = tc.batch(tab, "raw_u8", 46)
    tm, lut = _t(b["tm"]), _t(b["lut"])
    args = (_t(tab["packed"]), tab["V"], 2, tab["count_bits"], 3, 2, 24, tm,
            lut)
    assert torch.equal(multistep.stepped_count_many(*args),
                       multistep.stepped_count_many_plain(*args))
    dargs = (_t(tab["dflat"]), _t(tab["nb_out"]), tab["V"], 5, 2, 24, tm, lut)
    assert torch.equal(scan_dense.dense_count_many(*dargs),
                       scan_dense.dense_count_many_plain(*dargs))


@pytest.mark.parametrize("bad", ["long_tm", "flat_tm", "float_tm", "u8_ids",
                                 "odd_Lp", "odd_L", "int64_table"])
def test_count_many_wrappers_reject_bad_inputs(bad):
    tab = tc.tables(2)
    b = tc.batch(tab, "raw_u8", 46)
    packed, tm, lut = _t(tab["packed"]), _t(b["tm"]), _t(b["lut"])
    kw = dict(V=tab["V"], k=2, count_bits=tab["count_bits"], halo_steps=3,
              c=2, Lp=24)
    if bad == "long_tm":
        kw["c"] = 1
    elif bad == "flat_tm":
        tm = tm.reshape(-1)
    elif bad == "float_tm":
        tm = tm.float()
    elif bad == "u8_ids":
        lut = None
    elif bad == "odd_Lp":
        kw["Lp"] = 25
    elif bad == "odd_L":
        tm = tm[:-1]
    else:
        packed = packed.long()
    with pytest.raises(ValueError):
        multistep.stepped_count_many(packed, tm=tm, lut=lut, **kw)
