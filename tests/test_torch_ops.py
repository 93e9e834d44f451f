"""The port's plain op versions against the JAX package's functions, on the
same tables and the same seeded inputs, with exact integer equality.

K1 (dense count) is checked against the Pallas kernel in interpret mode,
as tests/test_pallas_kernel.py runs it, and against the XLA count; K2
against the XLA state scans (stream, sequential, time-major), its wrappers
and K6's requiring the sub-streams' warm-up; K3 against
the packed k-gram count; K4 and the two refinements against the JAX
retrieval phases; the prefilter's host filter copies, device block filter,
K7 (window counts) and K8 (bounded hits, stream and window forms) against
``ops/sparse.py`` and ``ops/hits.py``. Cases cover k in {1, 2, 3}, a halo
longer than a stream, and raw inputs with non-zero head_ids.
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
from aho_corasick_1975_tpu_torch.ops import hits, multistep, scan_dense, sparse

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
    assert torch.equal(multistep.stepped_count(*args, warm_steps=1),
                       multistep.stepped_count_plain(*args))
    for a, b in zip(hits.stepped_emit(*args, warm_steps=2),
                    hits.stepped_emit_plain(*args)):
        assert torch.equal(a, b)


def test_k4_wrapper_needs_the_warm_up():
    """K4's wrapper requires ``warm_steps`` (a keyword without a default)
    and refuses a negative one and a split that is no power of two up to
    32, on every device, before any launch; the tables' K4 warm-up is one
    symbol longer than the counts': ceil(max_depth / k) grams against
    ceil((max_depth - 1) / k)."""
    tab, hs, L, s = _stepped_case(3, "raw_u8", "halo")
    args = (_t(tab["packed"]), tab["V"], 3, tab["count_bits"], hs, B, L,
            _t(s["ext"]), _t(s["lut"]), _t(s["head_ids"]))
    with pytest.raises(TypeError, match="warm_steps"):
        hits.stepped_emit(*args)
    for bad in (dict(warm_steps=-1), dict(warm_steps=2, split=3),
                dict(warm_steps=2, split=64)):
        with pytest.raises(ValueError, match="warm_steps|split"):
            hits.stepped_emit(*args, **bad)
    t = tab["machine"].compile()
    assert t.max_depth == 6
    assert tab["emit_warm"] == multistep.emit_warm_steps_for(t, 3) == 2
    assert multistep.warm_steps_for(t, 3) == 2
    assert [multistep.emit_warm_steps_for(t, k) for k in (1, 2, 4)] == [
        6, 3, 2]
    assert [multistep.warm_steps_for(t, k) for k in (1, 2, 4)] == [5, 3, 2]


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
        multistep.stepped_count(packed, ext=ext, lut=lut, head_ids=head,
                                warm_steps=1, **kw)


def test_count_many_wrappers_on_cpu_are_the_plain_versions():
    tab = tc.tables(2)
    b = tc.batch(tab, "raw_u8", 46)
    tm, lut = _t(b["tm"]), _t(b["lut"])
    args = (_t(tab["packed"]), tab["V"], 2, tab["count_bits"], 3, 2, 24, tm,
            lut)
    assert torch.equal(multistep.stepped_count_many(*args, warm_steps=1),
                       multistep.stepped_count_many_plain(*args))
    dargs = (_t(tab["dflat"]), _t(tab["nb_out"]), tab["V"], 5, 2, 24, tm, lut)
    assert torch.equal(scan_dense.dense_count_many(*dargs, warm_steps=1),
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
        multistep.stepped_count_many(packed, tm=tm, lut=lut, warm_steps=1,
                                     **kw)


# -- the sparse prefilter ----------------------------------------------------

def _host_case(seed):
    """Mostly-OOV host inputs for the filter copies: ids, raw bytes and raw
    codepoints (past the LUT's end too), with a head."""
    rng = np.random.default_rng(seed)
    tab = tc.tables(1)
    ids = (rng.integers(0, tab["V"], 3001)
           * (rng.random(3001) < 0.01)).astype(np.int32)
    raw_u8 = rng.choice(np.frombuffer(b"abcd\0xy", np.uint8), 3001,
                        p=[.002, .002, .002, .002, .6, .2, .192])
    lut_cp = np.zeros(128, np.int32)
    lut_cp[[97, 98, 99, 100]] = tab["byte_lut"][[97, 98, 99, 100]]
    raw_i32 = rng.choice(np.array([97, 98, 0, 120, 4000], np.int32), 3001,
                         p=[.003, .003, .6, .294, .1])
    head = rng.integers(1, tab["V"], 7).astype(np.int32)
    return tab, ids, raw_u8, raw_i32, lut_cp, head


def test_live_blocks_match_jax():
    from aho_corasick_1975_tpu.ops import sparse as jsp
    _, ids, raw_u8, raw_i32, lut_cp, _ = _host_case(0)
    tab = tc.tables(1)
    for L_blk in (16, 128, 3001):
        np.testing.assert_array_equal(sparse.live_blocks(ids, L_blk),
                                      jsp.live_blocks(ids, L_blk))
        for raw, lut in ((raw_u8, tab["byte_lut"]), (raw_i32, lut_cp)):
            got = sparse.raw_live_blocks(raw, lut, len(lut), L_blk)
            want = jsp.raw_live_blocks(raw, lut, len(lut), L_blk)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("kind", ["ids", "raw_u8", "raw_i32"])
@pytest.mark.parametrize("pad_cols_to", [1, 3])
def test_elide_windows_match_jax(kind, pad_cols_to):
    from aho_corasick_1975_tpu.ops import sparse as jsp
    tab, ids, raw_u8, raw_i32, lut_cp, head = _host_case(1)
    arr, lut = {"ids": (ids, None), "raw_u8": (raw_u8, (tab["byte_lut"], 256)),
                "raw_i32": (raw_i32, (lut_cp, 128))}[kind]
    L_blk, halo = 16, 7
    live = (sparse.live_blocks(ids, L_blk) if lut is None else
            sparse.raw_live_blocks(arr, lut[0], lut[1], L_blk)[0])
    live[0] = True                       # block 0 reads the head
    n_live = int(live.sum())
    for h in (head, head[-3:], None):
        got = sparse.elide_windows(arr, lut, len(arr), live, n_live, h, halo,
                                   L_blk, len(live), pad_cols_to)
        want = jsp.elide_windows(arr, lut, len(arr), live, n_live, h, halo,
                                 L_blk, len(live), pad_cols_to)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype == np.int32


@pytest.mark.parametrize("prefilter", ["on", "auto"])
def test_raw_elision_plan_verdicts(prefilter):
    """Every verdict: "na" (halo wider than a block, and live windows over
    half the stream), "zero", "dense" (auto only) and "elide"."""
    from aho_corasick_1975_tpu.ops import sparse as jsp
    tab, _, raw_u8, raw_i32, lut_cp, _ = _host_case(2)
    lut = tab["byte_lut"]
    dense = np.frombuffer(b"abcd" * 400, np.uint8)
    halfway = np.frombuffer((b"a" + b"\0" * 31) * 50, np.uint8)
    cases = [(raw_u8, lut, 17, 16), (raw_u8, lut, 5, 128),
             (np.zeros(999, np.uint8), lut, 5, 16), (dense, lut, 5, 16),
             (halfway, lut, 15, 16), (raw_i32, lut_cp, 3, 64)]
    seen = set()
    for raw, lt, halo, L_blk in cases:
        got = sparse.raw_elision_plan(raw, lt, len(lt), prefilter, halo,
                                      L_blk)
        want = jsp.raw_elision_plan(raw, lt, len(lt), prefilter, halo, L_blk)
        assert got[0] == want[0] and got[2:] == want[2:]
        if want[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])
        seen.add(got[0])
    assert seen == ({"na", "zero", "dense", "elide"} if prefilter == "auto"
                    else {"na", "zero", "elide"})


def _sparse_case(k, kind="ids"):
    tab = tc.tables(k)
    hs = -(-5 // k)
    return tab, hs, tc.L_BLK[k], tc.sparse(tab, hs * k, tc.L_BLK[k], kind)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sparse_count_matches_jax(k):
    """K7's plain versions, index-list and elided forms, against the JAX
    sparse counts and the JAX counts of the elided windows."""
    from aho_corasick_1975_tpu.ops import sparse as jsp
    tab, hs, L_blk, s = _sparse_case(k)
    V, cb, nB = tab["V"], tab["count_bits"], s["nB"]
    cap = len(s["idx"])
    stepped = sparse.sparse_count_stepped_plain(
        _t(tab["packed"]), V, k, cb, hs, L_blk, _t(s["ext"]), _t(s["idx"]))
    want = jsp.make_sparse_count_stepped(V, k, V ** k, cb, hs, L_blk, nB,
                                         cap)(_j(tab["packed"]), _j(s["ext"]),
                                              _j(s["idx"]))
    np.testing.assert_array_equal(stepped.numpy(), np.asarray(want))
    assert int(stepped.sum()) > 0
    elided = sparse.sparse_count_stepped_plain(
        _t(tab["packed"]), V, k, cb, hs, L_blk, _t(s["tm"]))
    np.testing.assert_array_equal(elided.numpy(), np.asarray(
        jms.make_stepped_count(V, k, V ** k, cb, hs)(_j(tab["packed"]),
                                                     _j(s["tm"]))))
    assert int(elided.sum()) == int(stepped.sum())
    if k == 1:
        halo = hs
        args = (_t(tab["dflat"]), _t(tab["nb_out"]), V, halo, L_blk)
        dense = sparse.sparse_count_plain(*args, _t(s["ext"]), _t(s["idx"]))
        want = jsp.make_sparse_count(V, halo, L_blk, nB, cap)(
            _j(tab["dflat"]), _j(tab["nb_out"]), _j(s["ext"]), _j(s["idx"]))
        np.testing.assert_array_equal(dense.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            sparse.sparse_count_plain(*args, _t(s["tm"])).numpy(),
            np.asarray(jxla.make_blocked_count(V, halo)(
                _j(tab["dflat"]), _j(tab["nb_out"]), _j(s["tm"]))))


@pytest.mark.parametrize("k", [1, 2])
def test_block_filter_matches_jax(k):
    """The device filter and the _dev counts and hits over its order."""
    from aho_corasick_1975_tpu.ops import sparse as jsp
    tab, hs, L_blk, s = _sparse_case(k)
    V, cb, nB, halo = tab["V"], tab["count_bits"], s["nB"], hs * k
    order, n_live = sparse.block_filter(_t(s["ext"]), nB, L_blk, halo)
    j_order, j_n = jsp.make_block_filter(nB, L_blk, halo)(_j(s["ext"]))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert order.dtype == torch.int32 and n_live == int(j_n) == len(tc.LIVE)
    cap = 8
    idx = sparse.dev_idx(order, n_live, nB, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        jsp._dev_idx(j_order, j_n, nB, cap)))
    got = sparse.sparse_count_stepped_plain(_t(tab["packed"]), V, k, cb, hs,
                                            L_blk, _t(s["ext"]), idx)
    want = jsp.make_sparse_count_stepped_dev(V, k, V ** k, cb, hs, L_blk, nB,
                                             cap)(_j(tab["packed"]),
                                                  _j(s["ext"]), j_order, j_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if k == 1:
        args = (_j(tab["dflat"]), _j(tab["nb_out"]), _j(s["ext"]), j_order,
                j_n)
        got = sparse.sparse_count_plain(_t(tab["dflat"]), _t(tab["nb_out"]),
                                        V, halo, L_blk, _t(s["ext"]), idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jsp.make_sparse_count_dev(V, halo, L_blk, nB, cap)(*args)))
        tc.same_hits(hits.window_hits_plain(
            _t(tab["dflat"]), _t(tab["nb_out"]), V, halo, L_blk,
            _t(s["ext"]), idx),
            jsp.make_sparse_hits_dev(V, halo, L_blk, nB, cap, 512)(*args))


@pytest.mark.parametrize("kind", ["ids", "raw_u8"])
def test_window_hits_match_jax(kind):
    """K8's window form, index list and elided windows, against
    make_sparse_hits and make_elided_hits."""
    from aho_corasick_1975_tpu.ops import sparse as jsp
    tab, halo, L_blk, s = _sparse_case(1, kind)
    V, nB = tab["V"], s["nB"]
    tabs = (_t(tab["dflat"]), _t(tab["nb_out"]), V, halo, L_blk)
    jt = (_j(tab["dflat"]), _j(tab["nb_out"]))
    if kind == "ids":
        tc.same_hits(hits.window_hits_plain(*tabs, _t(s["ext"]), _t(s["idx"])),
                   jsp.make_sparse_hits(V, halo, L_blk, nB, 8, 512)(
                       *jt, _j(s["ext"]), _j(s["idx"])))
    tc.same_hits(hits.window_hits_plain(*tabs, _t(s["tm"]), _t(s["tm_idx"])),
               jsp.make_elided_hits(V, halo, L_blk, 512)(
                   *jt, _j(s["tm"]), _j(s["tm_idx"])))


@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_hits_match_jax(kind, shape):
    """K8's stream form against make_blocked_hits_stream / _raw."""
    tab, halo, L, s = _dense_case(kind, shape)
    V = tab["V"]
    got = hits.dense_hits_plain(_t(tab["dflat"]), _t(tab["nb_out"]), V, halo,
                                B, L, _t(s["ext"]), _t(s["lut"]),
                                _t(s["head_ids"]))
    jt = (_j(tab["dflat"]), _j(tab["nb_out"]))
    if s["lut"] is None:
        want = jhits.make_blocked_hits_stream(V, halo, 4096, B, L)(
            *jt, _j(s["ext"]))
    else:
        want = jhits.make_blocked_hits_raw(V, halo, 4096, B, L)(
            *jt, _j(s["lut"]), _j(s["ext"]), _j(s["head_ids"]))
    tc.same_hits(got, want)


def test_k2_modes_match_jax():
    """K2 in one thread (make_sequential_scan) and over a time-major batch
    (make_blocked_scan)."""
    tab = tc.tables(1)
    V = tab["V"]
    ids = tc.stream(tab, "ids", 0, 40)["ext"]
    got = scan_dense.sequential_states_plain(_t(tab["dflat"]), V, _t(ids))
    _, want = jxla.make_sequential_scan(V)(_j(tab["dflat"]), _j(ids),
                                          jnp.int32(0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tm = tc.batch(tab, "ids", 37, n_docs=5)["tm"]
    got = scan_dense.blocked_states_plain(_t(tab["dflat"]), V, _t(tm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jxla.make_blocked_scan(V)(_j(tab["dflat"]), _j(tm))))


@pytest.mark.parametrize("wrapper", ["dense_states", "blocked_states",
                                     "dense_count_many", "sparse_count"])
def test_k2_k6_wrappers_need_the_warm_up(wrapper):
    """K2's stream and time-major wrappers, K6's and K7 dense's
    (``sparse.sparse_count``, over an index list) require ``warm_steps``
    (a keyword without a default) and refuse a negative one and a split
    that is no power of two up to 32, on every device, before any launch;
    given them, on the CPU each is its plain version, the one-thread
    chain over every column."""
    tab = tc.tables(1)
    V, dflat, nb_out = tab["V"], _t(tab["dflat"]), _t(tab["nb_out"])
    module = sparse if wrapper == "sparse_count" else scan_dense
    if wrapper == "sparse_count":
        s = tc.sparse(tab, 5, tc.L_BLK[1])
        args = (dflat, nb_out, V, 5, tc.L_BLK[1], _t(s["ext"]),
                _t(s["idx"]))
    elif wrapper == "dense_states":
        s = tc.stream(tab, "raw_u8", 5, 24)
        args = (dflat, V, 5, B, 24, _t(s["ext"]), _t(s["lut"]),
                _t(s["head_ids"]))
    elif wrapper == "blocked_states":
        args = (dflat, V, _t(tc.batch(tab, "ids", 37, n_docs=5)["tm"]))
    else:
        b = tc.batch(tab, "raw_i32", 61)
        args = (dflat, nb_out, V, 5, 3, 24, _t(b["tm"]), _t(b["lut"]))
    fn = getattr(module, wrapper)
    plain = getattr(module, f"{wrapper}_plain")(*args)
    with pytest.raises(TypeError, match="warm_steps"):
        fn(*args)
    for bad in (dict(warm_steps=-1), dict(warm_steps=5, split=3),
                dict(warm_steps=5, split=64)):
        with pytest.raises(ValueError, match="warm_steps|split"):
            fn(*args, **bad)
    assert torch.equal(fn(*args, warm_steps=tab["warm_steps"], split=4),
                       plain)


def test_sparse_wrappers_on_cpu_are_the_plain_versions():
    tab, hs, L_blk, s = _sparse_case(2)
    args = (_t(tab["packed"]), tab["V"], 2, tab["count_bits"], hs, L_blk)
    for src, idx in ((_t(s["ext"]), _t(s["idx"])), (_t(s["tm"]), None)):
        assert torch.equal(sparse.sparse_count_stepped(*args, src, idx),
                           sparse.sparse_count_stepped_plain(*args, src, idx))
    tab, halo, L_blk, s = _sparse_case(1)
    targs = (_t(tab["dflat"]), _t(tab["nb_out"]), tab["V"], halo, L_blk,
             _t(s["ext"]), _t(s["idx"]))
    warm = tab["warm_steps"]
    assert torch.equal(sparse.sparse_count(*targs, warm_steps=warm),
                       sparse.sparse_count_plain(*targs))
    got = hits.window_hits(*targs, warm_steps=warm)
    want = hits.window_hits_plain(*targs)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    assert got[2:] == want[2:]
    with pytest.raises(ValueError, match="max_hits"):
        hits.window_hits(*targs, max_hits=got[3] - 1, warm_steps=warm)
    ids = _t(tc.stream(tab, "ids", 0, 40)["ext"])
    assert torch.equal(scan_dense.sequential_states(_t(tab["dflat"]),
                                                    tab["V"], ids),
                       scan_dense.sequential_states_plain(_t(tab["dflat"]),
                                                          tab["V"], ids))


@pytest.mark.parametrize("bad", ["short_ext", "no_idx", "idx_int64",
                                 "windows_rows", "float_windows",
                                 "odd_L_blk"])
def test_sparse_wrappers_reject_bad_inputs(bad):
    tab, hs, L_blk, s = _sparse_case(2)
    src, idx = _t(s["ext"]), _t(s["idx"])
    kw = dict(V=tab["V"], k=2, count_bits=tab["count_bits"], halo_steps=hs,
              L_blk=L_blk)
    if bad == "short_ext":
        src = src[:-1]
    elif bad == "no_idx":
        idx = None
    elif bad == "idx_int64":
        idx = idx.long()
    elif bad == "windows_rows":
        src, idx = _t(s["tm"])[1:], None
    elif bad == "float_windows":
        src, idx = _t(s["tm"]).float(), None
    else:
        kw["L_blk"] = L_blk - 1
    with pytest.raises(ValueError):
        sparse.sparse_count_stepped(_t(tab["packed"]), src=src, idx=idx,
                                    **kw)
