"""The port's ShardedScanner against the JAX package's, on the CPU.

The JAX scanner runs on conftest's 8 virtual CPU devices (``make_mesh(8)``),
the port's on a mesh of 8 CPU shards (``make_mesh(devices=["cpu"] * 8)``),
with the same ``n_streams_per_device`` and the same seeded inputs. Every
test of tests/test_sharded.py is mirrored here, plus the port's own cases:
a match planted across every shard edge, meshes of 1 and 3 shards, resident
ids out of [0, V) raising, a bounded feed_matches on a mesh session, the
``packed_only`` snapshot and the engine probe's rebind. Tolerance: exact
equality of counts, states, MatchSets (ends, end states, indices) and
session checkpoints.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import StreamSession as JaxSession
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu.parallel import mesh as jmesh
from aho_corasick_1975_tpu.parallel.sharded_scan import (
    ShardedScanner as JaxSharded, make_sharded_count)
from aho_corasick_1975_tpu_torch.models.scanner import StreamSession
from aho_corasick_1975_tpu_torch.ops import autotune
from aho_corasick_1975_tpu_torch.ops import multistep as pms
from aho_corasick_1975_tpu_torch.parallel.mesh import (data_sharded,
                                                       make_mesh, replicated)
from aho_corasick_1975_tpu_torch.parallel.sharded_scan import ShardedScanner


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return {n: (jmesh.make_mesh(n), make_mesh(devices=["cpu"] * n))
            for n in (1, 3, 8)}


def _pair(m, meshes, n=8, **kw):
    jm, pm = meshes[n]
    return JaxSharded(m, jm, **kw), ShardedScanner(m, pm, **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.end_states, b.end_states)
    np.testing.assert_array_equal(a.indices, b.indices)


def _jplaced(ids, n=8):
    jm = jmesh.make_mesh(n)
    return jax.device_put(ids, NamedSharding(jm, P(jmesh.DATA_AXIS)))


def _words_machine(seed, n, alpha, longest):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(n):
        m.insert_keyword("".join(rng.choice(alpha)
                                 for _ in range(rng.randint(1, longest))))
    return m, rng


# -- tests/test_sharded.py ---------------------------------------------------


def test_sharded_count_matches_single_chip(meshes):
    m, rng = _words_machine(42, 50, "abc", 6)
    text = "".join(rng.choice("abcx") for _ in range(4096))
    jsc, sc = _pair(m, meshes, n_streams_per_device=8)
    assert sc.count(text) == jsc.count(text) == \
        m.scanner(n_streams=16).count(text)
    np.testing.assert_array_equal(sc.scan_states(text), jsc.scan_states(text))


def test_sharded_device_resident_count(meshes):
    m, rng = _words_machine(7, 40, "abc", 5)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    text = "".join(rng.choice("abcx") for _ in range(8192))
    ids = np.asarray(m.vocab.lookup_many(text), np.int32)
    placed, jplaced = data_sharded(sc.mesh, ids), _jplaced(ids)
    expected = jsc.count(text)
    assert sc.count(placed) == jsc.count(jplaced) == expected
    assert sc.count(text) == expected
    head = np.asarray(m.vocab.lookup_many("ab"), np.int32)
    assert sc.count(placed, head=head) == jsc.count(jplaced, head=head) == \
        sc.count(text, head=head)
    # a tensor not yet on the mesh is placed there
    assert sc.count(torch.from_numpy(ids)) == expected
    with pytest.raises(ValueError, match="divisible"):
        sc.count(torch.from_numpy(ids[:8191]))
    with pytest.raises(ValueError, match="integer"):
        sc.count(torch.from_numpy(ids.astype(np.float32)))
    np.testing.assert_array_equal(sc.scan_states(placed),
                                  jsc.scan_states(jplaced))
    _same(sc.find_matches(placed), jsc.find_matches(jplaced))
    _same(sc.find_matches(placed, max_hits_per_shard=2048),
          jsc.find_matches(text))
    empty = torch.zeros(0, dtype=torch.int32)
    assert sc.count(empty) == 0
    assert len(sc.scan_states(empty)) == 0
    assert len(sc.find_matches(empty, max_hits_per_shard=8)) == 0


def test_match_spanning_shard_boundary(meshes):
    m = ac.Machine()
    m.insert_keyword("spanner")
    T = 8 * 64
    text = ["."] * T
    for edge in range(64, T, 64):
        text[edge - 3:edge + 4] = "spanner"
    text = "".join(text)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    assert sc.count(text) == jsc.count(text) == 7
    from aho_corasick_1975_tpu_torch.ops.decode import decode_matches
    events = decode_matches(sc.scan_states(text), sc.tables)
    assert sorted(ev.start for ev in events) == [e - 3 for e in
                                                 range(64, T, 64)]


def test_uneven_length_padding(meshes):
    m = ac.Machine()
    m.insert_keyword("ab")
    text = "ab" * 501 + "a"
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    assert sc.count(text) == jsc.count(text) == 501


def test_empty_and_tiny_streams(meshes):
    m = ac.Machine()
    m.insert_keyword("xy")
    jsc, sc = _pair(m, meshes, n_streams_per_device=2)
    assert sc.count("") == jsc.count("") == 0
    assert sc.count("xy") == jsc.count("xy") == 1


def test_sharded_allgather_hit_extraction(meshes):
    m = ac.Machine()
    m.insert_keyword("edge")
    m.insert_keyword("dg")
    T = 8 * 64
    text = ["."] * T
    for b in range(32, T, 64):
        for k, ch in enumerate("edge"):
            if b + k < T:
                text[b + k] = ch
    text = "".join(text)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    full = sc.find_matches(text)
    _same(full, jsc.find_matches(text))
    assert len(full) > 0
    _same(sc.find_matches(text, max_hits_per_shard=16), full)
    with pytest.raises(ValueError, match="over max_hits_per_shard"):
        sc.find_matches(text, max_hits_per_shard=1)


def test_sharded_refresh_matches_fresh(meshes):
    m, rng = _words_machine(7, 40, "abcd", 6)
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, step_k=2)
    text = "".join(rng.choice("abcd ") for _ in range(4096))
    base = sc.count(text)
    for _ in range(10):
        m.insert_keyword("".join(rng.choice("abcd")
                                 for _ in range(rng.randint(1, 6))))
    assert sc.refresh() == jsc.refresh()
    fresh = ShardedScanner(m, sc.mesh, n_streams_per_device=8, step_k=2)
    assert sc.count(text) == fresh.count(text) == jsc.count(text) >= base
    np.testing.assert_array_equal(sc.scan_states(text),
                                  fresh.scan_states(text))
    _same(sc.find_matches(text), jsc.find_matches(text))
    assert sc.version == m.version


def test_sharded_refresh_halo_growth(meshes):
    m = ac.Machine()
    m.insert_keyword("spanner")
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    long_kw = "spannerspannerspanner"
    m.insert_keyword(long_kw)
    sc.refresh()
    jsc.refresh()
    assert sc.halo == jsc.halo >= len(long_kw) - 1
    T = 8 * 64
    text = ["."] * T
    text[64 * 3 - 10:64 * 3 - 10 + len(long_kw)] = long_kw
    text = "".join(text)
    assert sc.count(text) == jsc.count(text) == 4


def test_sharded_refresh_grows_the_warm_up(meshes):
    """refresh() with a keyword of 21 letters grows the sharded scanner's
    stepped warm-up (``_warm_steps``, from the tables in ``_bind()``) with
    its halo, and K4's (``_emit_warm``, a symbol longer); count() (K3 per
    shard), count_many (K5 per shard) and find_matches() (K4 per shard)
    then equal the JAX ShardedScanner's and the host scan."""
    m = ac.Machine()
    m.insert_keyword("spanner")
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, step_k=2)
    assert sc._warm_steps == 3 and sc._emit_warm == 4
    long_kw = "spannerspannerspanner"
    m.insert_keyword(long_kw)
    sc.refresh()
    jsc.refresh()
    assert sc._warm_steps == -(-(len(long_kw) - 1) // 2)
    assert sc._emit_warm == -(-len(long_kw) // 2)
    text = ("." * 29 + long_kw + "," * 13) * 24
    host = m.match_stream(m.initiate(), text, parallel=False)
    assert sc.count(text) == jsc.count(text) == host > 24
    assert len(sc.find_matches(text)) == len(jsc.find_matches(text)) == host
    docs = [text[i:i + 300] for i in range(0, len(text), 300)]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))


def test_sharded_refresh_grows_the_1char_warm_up(meshes, monkeypatch):
    """A step_k=1 sharded scanner (no stepped table) derives the 1-char
    kernels' warm-up (``_warm_syms``) in ``_bind()``, and refresh() with a
    keyword of 21 letters grows it: count() (K1 per shard),
    find_matches(max_hits_per_shard=...) (K8's stream form) and a prefilter
    scanner's retrieval (K8's window form) then equal the JAX
    ShardedScanner's, and every K1 and K8 call gets the new warm-up and the
    real rows."""
    from aho_corasick_1975_tpu_torch.ops import hits, scan_dense
    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def run(*args, **kw):
            seen.append((name, kw["warm_steps"], kw["n_states"]))
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, run)
    spy(scan_dense, "dense_count")
    spy(hits, "dense_hits")
    spy(hits, "window_hits")
    m = ac.Machine()
    m.insert_keyword("spanner")
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, step_k=1)
    jscp, scp = _pair(m, meshes, n_streams_per_device=4, step_k=1,
                      prefilter="on")
    assert sc._stepped is None and sc._warm_syms == 6
    long_kw = "spannerspannerspanner"
    m.insert_keyword(long_kw)
    for s in (sc, jsc, scp, jscp):
        s.refresh()
    assert sc._warm_syms == scp._warm_syms == len(long_kw) - 1
    text = ("." * 29 + long_kw + "," * 13) * 24
    host = m.match_stream(m.initiate(), text, parallel=False)
    assert sc.count(text) == jsc.count(text) == host > 24
    _same(sc.find_matches(text, max_hits_per_shard=host),
          jsc.find_matches(text, max_hits_per_shard=host))
    sparse_text = "." * 9000 + long_kw + "." * 5000
    got = scp.find_matches(sparse_text)
    _same(got, jscp.find_matches(sparse_text))
    assert len(got) > 0
    assert {s[0] for s in seen} == {"dense_count", "dense_hits",
                                    "window_hits"}
    assert {s[1:] for s in seen} == {(len(long_kw) - 1,
                                      sc.tables.n_states)}


def test_sharded_count_beyond_int32(meshes):
    """The two-level reduction: per-stream int32 totals, an int64 sum on
    the host, exact past 2^31 (every 'a' emits 2^22 here)."""
    m = ac.Machine()
    m.insert_keyword("a")
    tables = m.compile()
    nb = np.array([0, 1 << 22], np.int32)
    fn = make_sharded_count(meshes[8][0], tables.vocab_size, halo=0)
    per = np.asarray(fn(jnp.asarray(tables.delta.reshape(-1)),
                        jnp.asarray(nb), _jplaced(np.ones(1024, np.int32))))
    sc = ShardedScanner(m, meshes[8][1], step_k=1)
    sc._snap.nb_out[:2] = torch.from_numpy(nb)
    ids = np.ones(1024, np.int32)
    assert sc.count(ids) == int(per.sum(dtype=np.int64)) == 2 ** 32


def test_sharded_session_chunked_count(meshes):
    m, rng = _words_machine(11, 30, "ab", 5)
    m.insert_keyword("spanner")
    text = list("".join(rng.choice("ab x") for _ in range(3000)))
    chunk = 700
    for edge in (chunk, 2 * chunk, 3 * chunk):
        text[edge - 3:edge + 4] = "spanner"
    text = "".join(text)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    want = m.scanner(n_streams=8).count(text)
    assert sc.count(text) == want
    s, js = sc.session(), jsc.session()
    for i in range(0, len(text), chunk):
        assert s.feed_count(text[i:i + chunk]) == \
            js.feed_count(text[i:i + chunk])
        a, b = s.checkpoint(), js.checkpoint()
        assert (a["offset"], a["total"], a["version"]) == \
            (b["offset"], b["total"], b["version"])
        np.testing.assert_array_equal(a["tail"], b["tail"])
    assert s.total == want


def test_sharded_session_matches_and_checkpoint(meshes):
    m = ac.Machine()
    for kw in ["he", "she", "hers", "edge"]:
        m.insert_keyword(kw)
    text = "ushers edge he xx edge hers " * 40
    chunks = [text[i:i + 230] for i in range(0, len(text), 230)]
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    s, js = sc.session(), jsc.session()
    for i, c in enumerate(chunks):
        if i == len(chunks) // 2:
            s = StreamSession.restore(sc, s.checkpoint())
            js = JaxSession.restore(jsc, js.checkpoint())
        _same(s.feed_matches(c), js.feed_matches(c))
    assert s.total == js.total > 0


def test_sharded_count_many_parity(meshes):
    m, rng = _words_machine(5, 25, "abc", 4)
    docs = ["".join(rng.choice("abcx") for _ in range(rng.randint(0, 300)))
            for _ in range(23)]
    jsc, sc = _pair(m, meshes, n_streams_per_device=4)
    got = sc.count_many(docs)
    np.testing.assert_array_equal(got, jsc.count_many(docs))
    np.testing.assert_array_equal(got, [m.scanner(n_streams=8).count(d)
                                        for d in docs])
    assert sc.count_many([]).shape == (0,)
    # a resident [L, B] batch, sharded along the document axis
    tm = np.zeros((384, 24), np.int32)
    for j, d in enumerate(docs):
        tm[:len(d), j] = m.vocab.lookup_many(d)
    want = jsc.count_many(jax.device_put(
        tm, NamedSharding(meshes[8][0], P(None, jmesh.DATA_AXIS))))
    np.testing.assert_array_equal(
        sc.count_many(data_sharded(sc.mesh, tm, axis=1)), want)
    np.testing.assert_array_equal(sc.count_many(torch.from_numpy(tm)), want)
    with pytest.raises(ValueError, match="divisible"):
        sc.count_many(torch.from_numpy(tm[:, :23]))


# -- the port's own cases ----------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("step_k", [1, "auto"])
def test_match_across_every_shard_edge(meshes, n, step_k):
    """A keyword planted across each shard edge of an uneven mesh: count,
    states, matches auto and bounded, from str and as resident ids."""
    m = ac.Machine()
    for kw in ("needle", "edl", "ne"):
        m.insert_keyword(kw)
    jsc, sc = _pair(m, meshes, n, n_streams_per_device=4, step_k=step_k)
    Tl = 200
    text = ["."] * (n * Tl)
    for edge in range(Tl, n * Tl, Tl):
        text[edge - 3:edge + 3] = "needle"
    text[:6] = "needle"
    text = "".join(text)
    assert sc.count(text) == jsc.count(text) == 3 * n
    np.testing.assert_array_equal(sc.scan_states(text), jsc.scan_states(text))
    want = jsc.find_matches(text)
    _same(sc.find_matches(text), want)
    _same(sc.find_matches(text, offset=9, max_hits_per_shard=8),
          jsc.find_matches(text, offset=9, max_hits_per_shard=8))
    ids = np.asarray(m.vocab.lookup_many(text), np.int32)
    placed = data_sharded(sc.mesh, ids)
    assert sc.count(placed) == 3 * n
    _same(sc.find_matches(placed), want)


def test_resident_ids_out_of_range_raise(meshes):
    m = ac.Machine()
    m.insert_keyword("ab")
    sc = ShardedScanner(m, meshes[8][1], n_streams_per_device=4)
    ids = np.ones(64, np.int32)
    for bad in (sc.V, -1):
        ids[37] = bad
        for x in (torch.from_numpy(ids), data_sharded(sc.mesh, ids)):
            with pytest.raises(ValueError, match="outside"):
                sc.count(x)
            with pytest.raises(ValueError, match="outside"):
                sc.find_matches(x)
        with pytest.raises(ValueError, match="outside"):
            sc.count_many(torch.from_numpy(ids.reshape(8, 8)))
    with pytest.raises(ValueError, match="outside"):
        sc.count("abab", head=np.array([sc.V], np.int32))


@pytest.mark.parametrize("step_k", [1, "auto"])
def test_bounded_feed_matches_on_a_mesh_session(meshes, step_k):
    """A mesh session's bounded feed_matches passes max_hits_per_shard."""
    m = ac.Machine()
    for kw in ["he", "she", "hers", "edge"]:
        m.insert_keyword(kw)
    text = "ushers edge he xx edge hers " * 30
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, step_k=step_k)
    s, js = sc.session(), jsc.session()
    for i in range(0, len(text), 170):
        c = text[i:i + 170]
        _same(s.feed_matches(c, max_hits=64), js.feed_matches(c, max_hits=64))
    with pytest.raises(ValueError, match="max_hits_per_shard"):
        sc.session().feed_matches(text, max_hits=1)


def _unpacked(orig):
    def build_stepped(tables, k, cap_rows=None):
        st = orig(tables, k)
        if st.packed is not None:
            cb = st.count_bits
            st.delta_k = (st.packed >> cb).astype(np.int32)
            st.cnt_k = (st.packed & ((1 << cb) - 1)).astype(np.int32)
            st.packed = st.cap_packed = None
            st.count_bits = 0
        return st
    return build_stepped


@pytest.mark.parametrize("unpacked", [False, True])
def test_packed_only_snapshot_is_bit_identical(monkeypatch, unpacked):
    """DeviceSnapshot(packed_only=True) holds the JAX snapshot's tables bit
    for bit; where only the two-table form fits (forced) both keep no
    k-gram table, and the mesh scanners built on it agree."""
    from aho_corasick_1975_tpu.models.snapshot import (
        DeviceSnapshot as JaxSnapshot)
    from aho_corasick_1975_tpu_torch.models.snapshot import DeviceSnapshot
    if unpacked:
        monkeypatch.setattr(jms, "build_stepped",
                            _unpacked(jms.build_stepped))
        monkeypatch.setattr(pms, "packed_count_bits",
                            lambda max_cnt, S: None)
    m, _ = _words_machine(3, 40, "abcd", 6)
    t = m.compile()
    js = JaxSnapshot(t, step_k=2, packed_only=True)
    ps = DeviceSnapshot(t, step_k=2, device="cpu", packed_only=True)
    assert ps.step_k == js.step_k == 2
    assert (ps.stepped is None) == (js.stepped is None) == unpacked
    assert ps.delta_k is None and ps.cnt_k is None
    np.testing.assert_array_equal(ps.dflat.numpy(), np.asarray(js.dflat))
    np.testing.assert_array_equal(ps.nb_out.numpy(), np.asarray(js.nb_out))
    if not unpacked:
        np.testing.assert_array_equal(ps.packed.numpy(),
                                      np.asarray(js.st_dev[0]))
    jsc, sc = JaxSharded(m, jmesh.make_mesh(8), step_k=2), ShardedScanner(
        m, make_mesh(devices=["cpu"] * 8), step_k=2)
    text = "abcd dcba abca" * 50
    assert sc.count(text) == jsc.count(text)
    _same(sc.find_matches(text), jsc.find_matches(text))


def test_refresh_writes_every_replica(meshes):
    """Four distinct devices (CPU indices, one replica each): a refresh
    writes rows and cells into every replica, and the mesh then counts as
    a fresh scanner and the JAX one do."""
    m, rng = _words_machine(4, 30, "abcd", 5)
    sc = ShardedScanner(m, make_mesh(devices=[f"cpu:{i}" for i in range(4)]),
                        n_streams_per_device=4, step_k=2)
    assert len(sc._snap.devices) == 4
    for _ in range(5):
        m.insert_keyword("".join(rng.choice("abcd") for _ in range(4)))
    assert sc.refresh() is True
    fresh = ShardedScanner(m, sc.mesh, n_streams_per_device=4, step_k=2)
    for d in sc._snap.devices:
        for name in ("dflat", "nb_out", "packed"):
            a = sc._snap.replica(d)[name]
            assert (a.data_ptr() == getattr(sc._snap, name).data_ptr()) == \
                (d == sc._snap.device)
            np.testing.assert_array_equal(
                a.numpy(), getattr(fresh._snap, name).numpy())
    text = "".join(rng.choice("abcd ") for _ in range(3000))
    jsc = JaxSharded(m, jmesh.make_mesh(4), n_streams_per_device=4, step_k=2)
    assert sc.count(text) == fresh.count(text) == jsc.count(text)
    _same(sc.find_matches(text), jsc.find_matches(text))


def test_calibrate_on_a_mesh_and_the_probe_rebind(monkeypatch, tmp_path):
    """calibrate=True probes each engine through autotune.probe, which
    rebinds a mesh scanner through the same ``_bind`` as DenseScanner's;
    the choice is cached under the mesh's key, and every engine counts
    exactly."""
    monkeypatch.setenv("ACX_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setattr(autotune, "PROBE_SYMBOLS", 1 << 11)
    autotune._MEM.clear()
    m, _ = _words_machine(9, 12, "ab", 4)
    mesh = make_mesh(devices=["cpu"] * 3)
    sc = ShardedScanner(m, mesh, n_streams_per_device=4, calibrate=True)
    assert set(sc.stats["calibration"]) == {"gather", "mxu", "hybrid"}
    key = autotune.geometry_key(m.compile().n_states, sc.V, sc.step_k,
                                "cpu") + "|mesh3"
    assert autotune.cached_choice(key) == sc._engine
    text = "abab ba bb aab x" * 60
    want = m.match_stream(m.initiate(), text)
    for engine in ("mxu", "hybrid", "gather"):
        assert autotune.probe(sc, [engine]) == engine
        assert sc._engine == engine and sc.count(text) == want
    assert sc.recalibrate() in ("gather", "mxu", "hybrid")
    autotune._MEM.clear()


def test_mesh_placement_helpers():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4} and mesh.local == [0, 1, 2, 3]
    x = np.arange(32, dtype=np.int32).reshape(4, 8)
    s = data_sharded(mesh, x, axis=1)
    assert s.shape == (4, 8) and len(s.shards) == 4
    np.testing.assert_array_equal(s.shards[2].numpy(), x[:, 4:6])
    assert list(replicated(mesh, x)) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="divisible"):
        data_sharded(mesh, np.zeros(6))
    with pytest.raises(ValueError, match="requested 5"):
        make_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA"):
            make_mesh()
