"""The port's ShardedScanner against the JAX package's: raw symbols, the
engines and the sparse prefilter, on the CPU.

The mirror of tests/test_sharded_raw.py (raw bytes and codepoints encoded
in the kernel, per engine, against the host encode and through a session),
tests/test_sharded_engines.py (hybrid, the prefilter's count, "auto"
declining, all-OOV, session carry, the 1-char table) and the mesh cases of
tests/test_sparse.py, test_sparse_device.py and test_sparse_hits.py (raw
elision, resident corpora with the device block filter, bounded and
auto-sized sparse retrieval, shard edges, overflow). The JAX scanner runs
on conftest's 8 CPU devices, the port's on 8 CPU shards. Exact equality of
counts, MatchSets and ``stats["sparse_live_frac"]`` /
``["sparse_elided_upload_bytes"]``.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.parallel import mesh as jmesh
from aho_corasick_1975_tpu.parallel.sharded_scan import (
    ShardedScanner as JaxSharded)
from aho_corasick_1975_tpu_torch.parallel.mesh import data_sharded, make_mesh
from aho_corasick_1975_tpu_torch.parallel.sharded_scan import ShardedScanner

HIT_WORDS = ["needle", "pin", "hay", "nee", "inha"]
KEYWORDS = ["needle", "haystack", "nee", "ack", "stacks", "ey", "needles"]


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jmesh.make_mesh(8), make_mesh(devices=["cpu"] * 8)


def _pair(m, meshes, **kw):
    return JaxSharded(m, meshes[0], **kw), ShardedScanner(m, meshes[1], **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.end_states, b.end_states)
    np.testing.assert_array_equal(a.indices, b.indices)


def _same_stats(sc, jsc):
    for key in ("sparse_live_frac", "sparse_elided_upload_bytes"):
        assert sc.stats.get(key) == jsc.stats.get(key), key


def _oracle(m, signs):
    return m.match_stream(m.initiate(), signs)


def _machine(seed=0, n=60, alpha="abcde", shortest=2, longest=7,
             as_bytes=False):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(n):
        w = "".join(rng.choice(alpha)
                    for _ in range(rng.randint(shortest, longest)))
        m.insert_keyword(w.encode() if as_bytes else w)
    return m


def _words(words, as_bytes=False):
    m = ac.Machine()
    for w in words:
        m.insert_keyword(w.encode() if as_bytes else w)
    return m


def _placed(meshes, sc, ids):
    return (data_sharded(sc.mesh, ids),
            jax.device_put(ids, NamedSharding(meshes[0], P(jmesh.DATA_AXIS))))


# -- tests/test_sharded_raw.py -----------------------------------------------


@pytest.mark.parametrize("engine", ["auto", "gather", "hybrid", "mxu"])
def test_sharded_raw_count_engines(meshes, engine):
    rng = random.Random(1)
    m = _machine(n=20 if engine == "mxu" else 80, as_bytes=True)
    text = "".join(rng.choice("abcdex ") for _ in range(60_000)).encode()
    jsc, sc = _pair(m, meshes, n_streams_per_device=16, engine=engine)
    assert sc._raw_stream(text) is not None
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)


def test_sharded_raw_equals_host_encode(meshes):
    rng = random.Random(2)
    m = _machine(as_bytes=True, n=80)
    text = "".join(rng.choice("abcde ") for _ in range(50_000)).encode()
    sc = ShardedScanner(m, meshes[1], n_streams_per_device=8)
    host = ShardedScanner(m, meshes[1], n_streams_per_device=8,
                          device_encode=False)
    assert host._raw_stream(text) is None
    assert sc.count(text) == host.count(text) == _oracle(m, text)


def test_sharded_raw_session_carry(meshes):
    rng = random.Random(3)
    m = _machine(as_bytes=True, n=80)
    text = "".join(rng.choice("abcde ") for _ in range(40_000)).encode()
    jsc, sc = _pair(m, meshes, n_streams_per_device=8)
    s, js = sc.session(), jsc.session()
    for i in range(0, len(text), 997):
        assert s.feed_count(text[i:i + 997]) == js.feed_count(text[i:i + 997])
    assert s.total == _oracle(m, text)


def test_sharded_raw_str_codepoints(meshes):
    rng = random.Random(4)
    m = _words(["héllo", "wörld", "héwö"])
    text = "".join(rng.choice("héllowörd ") for _ in range(30_000))
    jsc, sc = _pair(m, meshes, n_streams_per_device=8)
    assert sc._raw_stream(text) is not None
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)


def test_sharded_raw_snapshot_masks_new_letters(meshes):
    m = _machine(as_bytes=True, n=10)
    jsc, sc = _pair(m, meshes, n_streams_per_device=8)
    before = sc.count(b"abcde " * 500)
    m.insert_keyword(b"zzz")
    assert sc.count(b"abcde zzz " * 500) == jsc.count(b"abcde zzz " * 500)
    assert sc.count(b"abcde " * 500) == before
    sc.refresh()
    assert sc.count(b"zzz") == 1


# -- tests/test_sharded_engines.py --------------------------------------------


def test_sharded_hybrid_count_parity(meshes):
    m = _machine()
    rng = random.Random(1)
    text = "".join(rng.choice("abcdex") for _ in range(20000))
    jsc, sc = _pair(m, meshes, n_streams_per_device=32, step_k=2,
                    engine="hybrid")
    assert sc._hybrid is not None
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)
    ids = np.asarray(m.vocab.lookup_many(text[:16384]), np.int32)
    p, jp = _placed(meshes, sc, ids)
    assert sc.count(p) == jsc.count(jp)


def test_sharded_hybrid_session_and_refresh(meshes):
    m = _machine(seed=2, n=30)
    rng = random.Random(3)
    text = "".join(rng.choice("abcdex") for _ in range(8000))
    jsc, sc = _pair(m, meshes, n_streams_per_device=32, step_k=2,
                    engine="hybrid")
    s = sc.session()
    assert sum(s.feed_count(text[i:i + 331])
               for i in range(0, len(text), 331)) == _oracle(m, text)
    m.insert_keyword("abcde")
    assert sc.refresh() == jsc.refresh()
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)


@pytest.mark.parametrize("engine", ["mxu", "hybrid"])
def test_sharded_planes_t_per_replica_through_refresh(meshes, engine):
    """The kernels' planes keyed by (state, letter) are made once per
    replica in _bind(), beside the planes, and again by a refresh() that
    adds states; the counts still equal the JAX mesh's."""
    from aho_corasick_1975_tpu_torch.ops import scan_mxu
    m = _machine(seed=5, n=12 if engine == "mxu" else 30)
    jsc, sc = _pair(m, meshes, n_streams_per_device=16, step_k=2,
                    engine=engine)

    def check():
        planes, _, n_planes, _ = sc._mxu if engine == "mxu" else sc._hybrid
        assert set(sc._planes_t) == set(planes)
        for dev, p in planes.items():
            assert torch.equal(sc._planes_t[dev],
                               scan_mxu.transpose_planes(p, sc.V, n_planes))
        return dict(sc._planes_t)

    before, n0 = check(), m.n_states
    m.insert_keyword("abcdea")
    assert sc.refresh() == jsc.refresh()
    after = check()
    assert m.n_states > n0
    assert all(after[d] is not before[d] for d in before)
    text = "".join(random.Random(6).choice("abcdex") for _ in range(6000))
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)


def test_sharded_hybrid_tiny_stream_degenerates(meshes):
    m = _machine(seed=4, n=20)
    text = "abcde" * 40
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, step_k=2,
                    engine="hybrid")
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)


def test_sharded_sparse_count_parity(meshes):
    m = _machine(seed=5)
    rng = random.Random(6)
    dead = "".join(rng.choice("XYZ ") for _ in range(1500))
    island = "".join(rng.choice("abcde") for _ in range(97))
    text = (dead + island) * 11
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, step_k=2,
                    prefilter="on")
    dense = ShardedScanner(m, meshes[1], n_streams_per_device=8, step_k=2)
    assert sc.count(text) == jsc.count(text) == dense.count(text) == \
        _oracle(m, text)
    _same_stats(sc, jsc)
    assert sc.stats["sparse_live_frac"] < 0.5


def test_sharded_sparse_auto_declines_on_dense(meshes):
    m = _machine(seed=7, n=30)
    rng = random.Random(8)
    text = "".join(rng.choice("abcde") for _ in range(6000))
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, step_k=2,
                    prefilter="auto")
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)
    _same_stats(sc, jsc)
    assert sc.stats["sparse_live_frac"] > 0.5


def test_sharded_sparse_all_oov_short_circuits(meshes):
    m = _machine(seed=9, n=10)
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, prefilter="on")
    assert sc.count("XYZ " * 5000) == jsc.count("XYZ " * 5000) == 0


def test_sharded_sparse_session_carry(meshes):
    m = _machine(seed=10, n=25)
    rng = random.Random(11)
    island = "".join(rng.choice("abcde") for _ in range(61))
    text = (island + "XYZ " * 400) * 6 + island
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, step_k=2,
                    prefilter="on")
    s, js = sc.session(), jsc.session()
    for i in range(0, len(text), 777):
        assert s.feed_count(text[i:i + 777]) == js.feed_count(text[i:i + 777])
    assert s.total == _oracle(m, text)


def test_sharded_sparse_dense_table_path(meshes):
    m = _machine(seed=12, n=25)
    rng = random.Random(13)
    text = ("QQQQ " * 300 + "".join(rng.choice("abcde")
                                    for _ in range(50))) * 7
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, step_k=1,
                    prefilter="on")
    assert sc._stepped is None and jsc._stepped is None
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)
    _same_stats(sc, jsc)


# -- the mesh cases of tests/test_sparse*.py ---------------------------------


def test_sparse_raw_elision_sharded_parity(meshes):
    m = _words(KEYWORDS, as_bytes=True)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, prefilter="on")
    body = bytearray(60_000)
    for pos in (500, 8190, 29_999, 55_000):
        body[pos:pos + 6] = b"needle"
    data = bytes(body)
    assert sc.count(data) == jsc.count(data) == _oracle(m, data) > 0
    _same_stats(sc, jsc)
    s, js = sc.session(), jsc.session()
    for part in (data[:8193], data[8193:]):
        assert s.feed_count(part) == js.feed_count(part)
    assert s.total == _oracle(m, data)


def _islands(seed, islands=9, dead_len=1200, live_len=83):
    rng = random.Random(seed)
    dead = "".join(rng.choice("XYZQ ") for _ in range(dead_len))
    out = []
    for _ in range(islands):
        out.append(dead)
        out.append("".join(rng.choice("abcde") for _ in range(live_len)))
    return "".join(out)


def _aligned_ids(sc, text, unit=8 * 128):
    ids = np.asarray(sc.encode(text), np.int32)
    return np.concatenate([ids, np.zeros(-len(ids) % unit, np.int32)])


@pytest.mark.parametrize("bound", [None, 1 << 14])
def test_mesh_device_resident_sparse_find_matches_parity(meshes, bound):
    m = _machine(seed=24, n=40, shortest=2, longest=6)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, prefilter="on")
    text = _islands(25)
    p, jp = _placed(meshes, sc, _aligned_ids(sc, text))
    got = sc.find_matches(p, max_hits_per_shard=bound)
    _same(got, jsc.find_matches(jp, max_hits_per_shard=bound))
    _same(got, m.scanner(n_streams=8).find_matches(text))
    _same_stats(sc, jsc)
    assert sc.stats["sparse_live_frac"] < 0.5


def test_mesh_device_resident_sparse_session_head(meshes):
    m = _machine(seed=26, n=40, shortest=2, longest=6)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, prefilter="on")
    text = _islands(27)
    unit = 8 * 128
    T = len(text) // (2 * unit) * unit
    ids_a = np.asarray(sc.encode(text[:T]), np.int32)
    ids_b = np.asarray(sc.encode(text[T:2 * T]), np.int32)
    h = max(sc.halo, sc._halo_sym)
    head = ids_a[-h:] if h else None
    pa, jpa = _placed(meshes, sc, ids_a)
    pb, jpb = _placed(meshes, sc, ids_b)
    _same(sc.find_matches(pa), jsc.find_matches(jpa))
    _same(sc.find_matches(pb, offset=T, head=head),
          jsc.find_matches(jpb, offset=T, head=head))


def test_mesh_device_resident_sparse_count_parity(meshes):
    m = _machine(seed=30, n=40, shortest=2, longest=6)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, prefilter="on")
    text = _islands(31)
    p, jp = _placed(meshes, sc, _aligned_ids(sc, text))
    assert sc.count(p) == jsc.count(jp) == m.scanner(n_streams=8).count(text)
    _same_stats(sc, jsc)
    head = np.asarray(sc.encode("ab"), np.int32)
    assert sc.count(p, head=head) == jsc.count(jp, head=head)
    dp, jdp = _placed(meshes, sc, np.zeros(8 * 128 * 2, np.int32))
    assert sc.count(dp) == jsc.count(jdp) == 0


def _hit_corpus(rng, n=1500, p=0.08):
    parts = []
    for _ in range(n):
        parts.append("z" * rng.randint(40, 180))
        if rng.random() < p:
            parts.append(rng.choice(["needle", "pin", "hay", "haypin",
                                     "pinhay", "nee"]))
    return "".join(parts)


def test_mesh_elided_hits_parity(meshes):
    m = _words(HIT_WORDS)
    jsc, sc = _pair(m, meshes, n_streams_per_device=4, prefilter="on")
    text = "z" * 30_000 + "needle" + "z" * 20_000 + "pinhay" + "z" * 3000
    got = sc.find_matches(text, max_hits_per_shard=64)
    _same(got, jsc.find_matches(text, max_hits_per_shard=64))
    _same(got, m.scanner().find_matches(text))
    _same(sc.find_matches(text), jsc.find_matches(text))
    _same_stats(sc, jsc)
    s, js = sc.session(), jsc.session()
    for part in (text[:30_003], text[30_003:]):
        _same(s.feed_matches(part, max_hits=64),
              js.feed_matches(part, max_hits=64))
    with pytest.raises(ValueError, match="max_hits_per_shard"):
        sc.find_matches(text, max_hits_per_shard=1)


@pytest.mark.parametrize("bound", [None, 4096])
def test_mesh_sparse_hits_parity(meshes, bound):
    m = _words(HIT_WORDS)
    jsc, sc = _pair(m, meshes, prefilter="on")
    text = _hit_corpus(random.Random(7), n=500)
    got = sc.find_matches(text, max_hits_per_shard=bound)
    assert len(got.ends) > 0
    _same(got, jsc.find_matches(text, max_hits_per_shard=bound))
    _same(got, m.scanner().find_matches(text))
    ids = np.asarray(sc.encode(text), np.int32)   # host ids: indexed path
    _same(sc.find_matches(ids, max_hits_per_shard=bound),
          jsc.find_matches(ids, max_hits_per_shard=bound))
    _same_stats(sc, jsc)


def test_mesh_sparse_hits_shard_boundary(meshes):
    m = _words(HIT_WORDS)
    jsc, sc = _pair(m, meshes, prefilter="on")
    shard = "z" * (4 * 128)
    text = list(shard * 8)
    for d in range(1, 8):
        pos = d * len(shard) - 3
        text[pos:pos + 6] = "needle"
    text = "".join(text)
    got = sc.find_matches(text, max_hits_per_shard=64)
    assert len(got.ends) == 2 * 7
    _same(got, jsc.find_matches(text, max_hits_per_shard=64))
    ids = np.asarray(sc.encode(text), np.int32)
    p, jp = _placed(meshes, sc, ids)
    _same(sc.find_matches(p), jsc.find_matches(jp))
    assert sc.count(p) == jsc.count(jp) == 14


def test_mesh_sparse_hits_overflow(meshes):
    m = _words(HIT_WORDS)
    sc = ShardedScanner(m, meshes[1], prefilter="on")
    text = _hit_corpus(random.Random(8), n=400)
    with pytest.raises(ValueError, match="max_hits_per_shard"):
        sc.find_matches(text, max_hits_per_shard=1)
    ids = np.asarray(sc.encode(text), np.int32)
    with pytest.raises(ValueError, match="max_hits_per_shard"):
        sc.find_matches(ids, max_hits_per_shard=1)


@pytest.mark.parametrize("step_k", [1, 2])
def test_mesh_mxu_engine_parity(meshes, step_k):
    """engine="mxu" on the mesh: count from bytes and a resident tensor,
    count_many (K10's batch form), find_matches bounded (K8's stream form)
    and auto (the full decode), the prefilter's counts."""
    rng = random.Random(14)
    m = _machine(seed=15, n=15, as_bytes=True)
    jsc, sc = _pair(m, meshes, n_streams_per_device=8, engine="mxu",
                    step_k=step_k)
    text = "".join(rng.choice("abcdex ") for _ in range(12_000)).encode()
    assert sc.count(text) == jsc.count(text) == _oracle(m, text)
    p, jp = _placed(meshes, sc, np.asarray(sc.encode(text), np.int32))
    assert sc.count(p) == jsc.count(jp)
    docs = [text[i * 700:i * 700 + rng.randint(0, 700)] for i in range(11)]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))
    _same(sc.find_matches(text[:3000], max_hits_per_shard=1024),
          jsc.find_matches(text[:3000], max_hits_per_shard=1024))
    _same(sc.find_matches(text[:3000]), jsc.find_matches(text[:3000]))
    sp = ShardedScanner(m, meshes[1], engine="mxu", prefilter="on")
    sparse = bytes(20_000) + b"abcde" * 3 + bytes(9000)
    assert sp.count(sparse) == _oracle(m, sparse)
