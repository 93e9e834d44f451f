"""The port's count engines against the JAX scanner's: ``engine="mxu"``
(K10), ``engine="hybrid"`` (K11) and ``calibrate=True``.

The single-device cases of tests/test_mxu_engine.py, test_hybrid_engine.py
and test_autotune.py, with the JAX scanner run with the same ``engine=`` on
the CPU (XLA's int8 product) and the port's on ``device="cpu"``, where the
kernel wrappers take their plain versions. Counts are integers: every
comparison is exact. Inputs are made from seeds at small sizes.
"""

import ctypes
import random
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.ops import autotune as jautotune
from aho_corasick_1975_tpu.ops import scan_mxu as jmxu
from aho_corasick_1975_tpu_torch import Machine
from aho_corasick_1975_tpu_torch.ops import (autotune, build, scan_hybrid,
                                             scan_mxu)

ENGINES = ("mxu", "hybrid")


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ACX_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    # the plain versions run one Python step per symbol row: a smaller
    # probe keeps calibration's timings of them short
    monkeypatch.setattr(autotune, "PROBE_SYMBOLS", 1 << 12)
    autotune._MEM.clear()
    jautotune._MEM.clear()
    yield
    autotune._MEM.clear()
    jautotune._MEM.clear()


def _words(seed=3, n=30, alpha="abcd", longest=6):
    rng = random.Random(seed)
    return ["".join(rng.choice(alpha) for _ in range(rng.randint(1, longest)))
            for _ in range(n)]


def _pair(words):
    jm, pm = ac.Machine(), Machine()
    for w in words:
        jm.insert_keyword(w)
        pm.insert_keyword(w)
    return jm, pm


def _text(seed, n, alpha="abcdx "):
    rng = random.Random(seed)
    return "".join(rng.choice(alpha) for _ in range(n))


def _scanners(jm, pm, **kw):
    return jm.scanner(**kw), pm.scanner(device="cpu", **kw)


@pytest.mark.parametrize("n_streams", [8, 3])
@pytest.mark.parametrize("engine,step_k", [
    ("mxu", "auto"), ("mxu", 1), ("mxu", 2), ("mxu", 3),
    ("hybrid", "auto"), ("hybrid", 2), ("hybrid", 3)])
def test_counts_equal_reference(engine, step_k, n_streams):
    """Every input kind, with and without a head, OOV letters included,
    and an odd number of streams (masked rows of K10's warp tile). The
    hybrid engine needs the packed table that an explicit step_k=1
    leaves out (test_hybrid_without_packed_table_raises_in_both)."""
    jm, pm = _pair([w.encode() for w in _words()])
    jsc, sc = _scanners(jm, pm, n_streams=n_streams, engine=engine,
                        step_k=step_k)
    assert (sc._mxu is None, sc._hybrid is None) == \
        (jsc._mxu is None, jsc._hybrid is None)
    assert (sc._mxu if engine == "mxu" else sc._hybrid) is not None
    data = _text(1, 1500).encode()
    ids = jsc.encode(data)
    head = ids[:5]
    for signs in (data, data.decode(), np.frombuffer(data, np.uint8), ids):
        assert sc.count(signs) == jsc.count(signs)
        assert sc.count(signs, head=head) == jsc.count(signs, head=head)
    t_ids = torch.from_numpy(ids.astype(np.int64))
    assert sc.count(t_ids) == jsc.count(jnp.asarray(ids)) > 0
    assert sc.count(t_ids, head=head) == jsc.count(jnp.asarray(ids),
                                                   head=head)
    assert sc.count(b"") == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_count_matches_gather_and_oracle(engine):
    words = ["he", "she", "his", "hers", "ushers", "hush", "sells",
             "seashells", "s", "hi", "shells", "ell"]
    jm, pm = _pair(words)
    text = ("To ushers: he found his pencil, but she could not find hers. "
            "ushers rush in; she sells seashells; his hissing hush. ") * 10
    sc = pm.scanner(device="cpu", engine=engine, n_streams=16)
    gather = pm.scanner(device="cpu", engine="gather", n_streams=16)
    want = pm.match_stream(pm.initiate(), text)
    assert sc.count(text) == gather.count(text) == want \
        == jm.scanner(engine=engine, n_streams=16).count(text)


@pytest.mark.parametrize("engine", ENGINES)
def test_session_totals(engine):
    jm, pm = _pair(_words())
    jsc, sc = _scanners(jm, pm, n_streams=8, engine=engine)
    for size, n in ((7, 280), (500, 2000)):
        text = _text(4, n, "abcd")
        js, ps = jsc.session(), sc.session()
        for i in range(0, len(text), size):
            assert ps.feed_count(text[i:i + size]) == \
                js.feed_count(text[i:i + size])
        assert ps.total == js.total == pm.match_stream(pm.initiate(), text)


@pytest.mark.parametrize("engine", ENGINES)
def test_refresh_rounds(engine):
    """Online keywords, refreshed in place or rebuilt: the planes are
    rebuilt with the tables and count equal to the JAX scanner's; a
    keyword across a session's chunk edge is found."""
    jm, pm = _pair(_words())
    jsc, sc = _scanners(jm, pm, n_streams=8, engine=engine)
    text = list(_text(6, 2000, "abcd"))
    for edge in (500, 1000):
        for k, ch in enumerate("spanner"):
            text[edge - 3 + k] = ch
    text = "".join(text)
    for i in range(4):
        new = ["spanner"] if i == 0 else _words(10 + i, 3, "abcdnpr", 7)
        for w in new:
            jm.insert_keyword(w)
            pm.insert_keyword(w)
        assert sc.refresh() == jsc.refresh()
        planes = sc._mxu if engine == "mxu" else sc._hybrid
        jplanes = jsc._mxu if engine == "mxu" else jsc._hybrid
        np.testing.assert_array_equal(planes[0].numpy(),
                                      np.asarray(jplanes[0]))
        assert planes[1:] == jplanes[1:]
        assert sc.count(text) == jsc.count(text)
        sess = sc.session()
        total = sum(sess.feed_count(text[j:j + 500])
                    for j in range(0, len(text), 500))
        assert total == jsc.count(text) == pm.match_stream(pm.initiate(),
                                                           text)


@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_bodies_read_planes_t_after_refresh(engine):
    """After a refresh() that adds states, the scanner's planes_t (made in
    _bind(), never per call) is the permute of its new planes, and K10's
    or K11's g++ body reading it (K11's gather half with the warm-up
    _bind() derived) counts a text as the JAX scanner and the host scan
    do."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = build.host_library()
    jm, pm = _pair(_words())
    jsc, sc = _scanners(jm, pm, n_streams=8, engine=engine)
    before = (pm.n_states, sc._planes_t)
    for w in _words(21, 12, "abcdnpr", 7):
        jm.insert_keyword(w)
        pm.insert_keyword(w)
    assert sc.refresh() == jsc.refresh()
    planes, cbm, n_planes, _ = sc._mxu if engine == "mxu" else sc._hybrid
    assert pm.n_states > before[0] and sc._planes_t is not before[1]
    assert torch.equal(sc._planes_t,
                       scan_mxu.transpose_planes(planes, sc.V, n_planes))
    text = _text(9, 3000, "abcdnpr ")
    ids = np.asarray(sc.encode(text), np.int32)
    n, st = 8, sc._stepped
    k = st.k if engine == "hybrid" else 1
    L = -(-len(ids) // (n * k)) * k
    halo = sc._halo_sym if engine == "hybrid" else sc.halo
    ext = np.zeros(halo + n * L, np.int32)
    ext[halo:halo + len(ids)] = ids
    out = torch.full((n,), -7, dtype=torch.int32)
    fields = dict(ext=torch.from_numpy(ext), out=out, L=L, B=n, halo=halo,
                  layout=0, **scan_mxu.mxu_fields(
                      planes, sc.V, cbm, n_planes, sc._planes_t))
    if engine == "hybrid":
        fields.update(table=sc._snap.packed, Vk=st.V ** k, k=k,
                      count_bits=st.count_bits, B1=3,
                      warm_steps=sc._warm_steps)
    args = build.scan_args(**fields)
    name = "ac_mxu_count" if engine == "mxu" else "ac_hybrid_count"
    assert getattr(lib, name)(ctypes.byref(args), None) == 0
    assert int(out.sum()) == jsc.count(text) == pm.match_stream(
        pm.initiate(), text) > 0


def test_refresh_that_outgrows_the_mxu_engine_raises_in_both():
    jm, pm = _pair(_words(n=12))
    jsc, sc = _scanners(jm, pm, n_streams=8, engine="mxu")
    big = _words(7, 300, "abcdefgh", 7)
    for w in big:
        jm.insert_keyword(w)
        pm.insert_keyword(w)
    assert pm.n_states > scan_mxu.MAX_MXU_STATES
    with pytest.raises(ValueError, match="too large for the MXU engine"):
        jsc.refresh()
    with pytest.raises(ValueError, match="too large for the MXU engine"):
        sc.refresh()


def test_too_large_automata_raise_and_auto_takes_gather():
    rng = random.Random(9)
    words = ["".join(rng.choice("abcdefgh") for _ in range(7))
             for _ in range(2000)]
    jm, pm = _pair(words)
    assert pm.n_states > 512
    for m, kw in ((jm, {}), (pm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="too large for the MXU engine"):
            m.scanner(engine="mxu", **kw)
    sc = pm.scanner(engine="auto", n_streams=8, device="cpu")
    assert sc._mxu is None and sc._hybrid is None
    assert sc.count("abcdefgh") == jm.scanner(n_streams=8).count("abcdefgh")


def test_oversize_hybrid_raises_in_both():
    rng = np.random.default_rng(0)
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26, size=9))
             for _ in range(scan_hybrid.MAX_HYBRID_STATES // 4)]
    jm, pm = _pair(words)
    assert pm.n_states > scan_hybrid.MAX_HYBRID_STATES
    for m, kw in ((jm, {}), (pm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="hybrid"):
            m.scanner(engine="hybrid", **kw)


def test_hybrid_without_packed_table_raises():
    """Without a k-gram table (explicit step_k=1) the JAX scanner quietly
    counts through the gather engine; the port raises, as it does where
    the table is unpacked (tests/test_torch_unpacked.py), rather than hide
    that K11 does not run."""
    jm, pm = _pair(_words())
    jsc = jm.scanner(engine="hybrid", step_k=1)
    assert jsc._hybrid is None
    with pytest.raises(ValueError, match="hybrid"):
        pm.scanner(engine="hybrid", step_k=1, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_count_many_equals_reference(engine):
    jm, pm = _pair(_words())
    jsc, sc = _scanners(jm, pm, n_streams=8, engine=engine)
    rng = random.Random(8)
    docs = [_text(rng.randint(0, 99), rng.randint(0, 700)) for _ in range(13)]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))
    np.testing.assert_array_equal(
        sc.count_many([d.encode() for d in docs]),
        jsc.count_many([d.encode() for d in docs]))
    long_docs = [_text(20 + i, 3000, "abcd") for i in range(2)]
    np.testing.assert_array_equal(sc.count_many(long_docs),
                                  jsc.count_many(long_docs))
    tm = np.zeros((384, 5), np.int32)
    for j, d in enumerate(docs[:5]):
        e = jsc.encode(d)[:384]
        tm[:len(e), j] = e
    np.testing.assert_array_equal(sc.count_many(torch.from_numpy(tm)),
                                  jsc.count_many(jnp.asarray(tm)))


@pytest.mark.parametrize("kind", ["bytes", "ids", "tensor"])
def test_prefilter_with_the_mxu_engine(kind):
    """prefilter="on" counts live windows through K10's window forms
    (elided and index list), with the JAX scanner's stats."""
    jm, pm = _pair([w.encode() for w in _words(n=20)])
    jsc, sc = _scanners(jm, pm, n_streams=8, engine="mxu", prefilter="on")
    rng = np.random.default_rng(3)
    data = np.zeros(40_000, np.uint8)
    for start in rng.integers(0, len(data) - 16, 30):
        data[start:start + 8] = rng.choice(np.frombuffer(b"abcd", np.uint8),
                                           8)
    data = data.tobytes()
    ids = jsc.encode(data)
    signs = {"bytes": (data, data), "ids": (ids, ids),
             "tensor": (torch.from_numpy(ids), jnp.asarray(ids))}[kind]
    assert sc.count(signs[0]) == jsc.count(signs[1]) > 0
    assert sc._sparse_geometry() == (1, sc.halo, 128)
    for key in ("sparse_live_frac", "sparse_elided_upload_bytes"):
        assert sc.stats.get(key) == jsc.stats.get(key)


def test_planes_bit_identical_to_reference():
    for seed, n, alpha in ((0, 12, "abcd"), (1, 60, "abcdefgh"),
                           (2, 200, "abcdefghij")):
        t = ac.Machine()
        for w in _words(seed, n, alpha):
            t.insert_keyword(w)
        tabs = t.compile()
        for max_states in (None, scan_hybrid.MAX_HYBRID_STATES):
            got = scan_mxu.build_planes(tabs.delta, tabs.nb_outputs,
                                        max_states=max_states)
            want = jmxu.build_planes(tabs.delta, tabs.nb_outputs,
                                     max_states=max_states)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1:] == want[1:]
    assert scan_hybrid.mxu_cols(16384, 4480) == 448
    from aho_corasick_1975_tpu.ops import scan_hybrid as jhybrid
    for B, S_pad in ((16384, 4480), (512, 128), (8, 8192), (4096, 1024)):
        assert scan_hybrid.mxu_cols(B, S_pad) == jhybrid.mxu_cols(B, S_pad)


# -- calibration (tests/test_autotune.py) ------------------------------------


def _calib_machine(seed=0, n=12):
    rng = random.Random(seed)
    m = Machine()
    for _ in range(n):
        m.insert_keyword("".join(rng.choice("ab")
                                 for _ in range(rng.randint(2, 5))))
    return m


def test_calibrate_probes_picks_and_stays_conformant():
    m = _calib_machine()
    sc = m.scanner(calibrate=True, n_streams=16, device="cpu")
    assert sc._engine in ("gather", "mxu", "hybrid")
    assert set(sc.stats["calibration"]) == {"gather", "mxu", "hybrid"}
    text = "abab ba bb aab" * 200
    assert sc.count(text) == m.match_stream(m.initiate(), text)
    key = autotune.geometry_key(m.compile().n_states, sc.V, sc.step_k, "cpu")
    assert key.startswith("torch|cpu|cpu|")
    assert autotune.cached_choice(key) == sc._engine
    # the JAX package's key for the same geometry is another entry
    jkey = jautotune.geometry_key(m.compile().n_states, sc.V, sc.step_k)
    assert jkey != key and jautotune.cached_choice(jkey) is None


def test_second_scanner_uses_cache_without_probing():
    m = _calib_machine()
    sc1 = m.scanner(calibrate=True, n_streams=16, device="cpu")
    sc2 = m.scanner(calibrate=True, n_streams=16, device="cpu")
    assert sc2._engine == sc1._engine
    assert "calibration" not in sc2.stats


def test_a_choice_the_jax_package_cached_does_not_steer_the_port():
    m = _calib_machine()
    tabs = m.compile()
    plain = m.scanner(n_streams=16, device="cpu")
    jautotune.store_choice(
        jautotune.geometry_key(tabs.n_states, plain.V, plain.step_k), "mxu")
    sc = m.scanner(calibrate=True, n_streams=16, device="cpu")
    assert "calibration" in sc.stats


def test_single_candidate_skips_probe():
    rng = random.Random(1)
    m = Machine()
    for _ in range(4000):
        m.insert_keyword("".join(rng.choice("abcdefghijklmnop")
                                 for _ in range(8)))
    sc = m.scanner(calibrate=True, device="cpu")
    assert sc._engine == "gather"
    assert "calibration" not in sc.stats


def test_recalibrate_is_safe_while_another_thread_scans():
    m = _calib_machine(2, n=10)
    sc = m.scanner(n_streams=16, device="cpu")
    text = "abab ba bb aab" * 20
    expected = m.match_stream(m.initiate(), text)
    errors = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            got = sc.count(text)
            if got != expected:
                errors.append(got)
                return

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            assert sc.recalibrate() in ("gather", "mxu", "hybrid")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sc.count(text) == expected


@pytest.mark.parametrize("kind", ["dense", "mesh"])
def test_planes_are_built_once_per_rebind_and_calibration(monkeypatch, kind):
    """Both scanners bind through one derivation: a rebind builds the
    digit planes once, and a calibration once for its candidates, the
    probe's rebinds and the winner; the halo and warm-ups agree between
    the two scanners."""
    from aho_corasick_1975_tpu_torch.parallel.mesh import make_mesh
    from aho_corasick_1975_tpu_torch.parallel.sharded_scan import (
        ShardedScanner)
    calls = []
    build_planes = scan_mxu.build_planes

    def counted(*a, **kw):
        calls.append(kw.get("max_states"))
        return build_planes(*a, **kw)

    monkeypatch.setattr(scan_mxu, "build_planes", counted)
    m = _calib_machine()

    def scanner(**kw):
        if kind == "dense":
            return m.scanner(n_streams=16, device="cpu", **kw)
        return ShardedScanner(m, make_mesh(devices=["cpu"] * 2),
                              n_streams_per_device=8, **kw)

    sc = scanner(engine="hybrid")
    assert len(calls) == 1 and sc._hybrid is not None
    calls.clear()
    sc = scanner(calibrate=True)
    assert set(sc.stats["calibration"]) == {"gather", "mxu", "hybrid"}
    assert len(calls) == 1
    calls.clear()
    sc.recalibrate()
    assert len(calls) == 1
    other = (ShardedScanner(m, make_mesh(devices=["cpu"] * 2),
                            n_streams_per_device=8) if kind == "dense"
             else m.scanner(n_streams=16, device="cpu"))
    for name in ("_halo_steps", "_halo_sym", "_warm_steps", "_emit_warm",
                 "_warm_syms"):
        assert getattr(sc, name) == getattr(other, name), name
