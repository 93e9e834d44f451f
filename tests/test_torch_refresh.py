"""The port's refresh() (device="cpu") against a fresh scanner and the JAX
package's refresh.

The cases of tests/test_refresh.py other than the unpacked two-table mode
(the port drops that table): after online insertions a refreshed scanner
scans exactly as a freshly built one, takes the in-place path where the
reference does and rebuilds where it does, and its device tables equal the
JAX snapshot's bit for bit after the same insertions. The port's device
diff finds the JAX package's changed rows and stepped_delta_cells' cells,
and an in-place refresh at Test 3's shape class, in the two-table form and
on a mesh's replicas leaves the tables of a fresh snapshot. find_matches
after a refresh
goes through the per-version packed k=1 table, and counts through the
rebound halo and the stepped and 1-char kernels' rebound warm-ups.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu_torch import ByteMachine, DenseScanner, Machine
from aho_corasick_1975_tpu_torch.ops import hits
from aho_corasick_1975_tpu_torch.ops import multistep as ms

TEXT = "To ushers: he found his pencil, but she could not find hers."


def fresh_like(m, **kw):
    kw.setdefault("n_streams", 4)
    kw.setdefault("step_k", 2)
    return DenseScanner(m, device="cpu", **kw)


def assert_equiv(sc, m, text, **kw):
    fresh = fresh_like(m, **kw)
    assert sc.count(text) == fresh.count(text)
    np.testing.assert_array_equal(sc.scan_states(text),
                                  fresh.scan_states(text))
    a = [(ev.start, ev.end, ev.index, mt.rank, tuple(mt.letters))
         for ev, mt in sc.find_matches(text)]
    b = [(ev.start, ev.end, ev.index, mt.rank, tuple(mt.letters))
         for ev, mt in fresh.find_matches(text)]
    assert a == b
    return fresh


def _same_tables(sc, jsc):
    """The port's device tables equal the JAX snapshot's, bit for bit."""
    snap = sc._snap
    np.testing.assert_array_equal(snap.dflat.numpy(), np.asarray(jsc._dflat))
    np.testing.assert_array_equal(snap.nb_out.numpy(),
                                  np.asarray(jsc._nb_out))
    assert (snap.packed is None) == (jsc._stepped is None)
    if snap.packed is not None:
        np.testing.assert_array_equal(snap.packed.numpy(),
                                      np.asarray(jsc._st_dev[0]))
        assert sc._stepped.count_bits == jsc._stepped.count_bits
    assert (sc.halo, sc._halo_steps, sc._halo_sym) == (
        jsc.halo, jsc._halo_steps, jsc._halo_sym)


def test_refresh_in_place_equals_fresh_and_reference():
    m = Machine()
    for w in ["he", "she", "his", "hers"]:
        m.insert_keyword(w)
    sc = fresh_like(m)
    jsc = JaxScanner(m, n_streams=4, step_k=2)
    assert sc.count(TEXT) == 9
    cap, ptr = sc._snap.cap, sc._snap.packed.data_ptr()
    for w in ["is", "her", "hiss", "shes", "here"]:
        m.insert_keyword(w)
    assert sc.refresh() is True and jsc.refresh() is True
    assert sc.version == m.version == jsc.version
    assert sc.stats["refresh_rows"] == jsc.stats["refresh_rows"] > 0
    assert sc.stats["refresh_cells"] == jsc.stats["refresh_cells"] > 0
    assert sc.stats["last_op"] == "refresh"
    # in place: same capacity, same buffer
    assert sc._snap.cap == cap and sc._snap.packed.data_ptr() == ptr
    _same_tables(sc, jsc)
    assert_equiv(sc, m, TEXT)


def test_refresh_noop_on_duplicate_insert():
    m = Machine()
    m.insert_keyword("he")
    sc = fresh_like(m)
    before = sc._snap.packed.clone()
    m.insert_keyword("he")            # version bump, no table change
    assert sc.refresh() is True
    assert sc.version == m.version
    assert torch.equal(sc._snap.packed, before)
    assert sc.count("he he") == 2
    assert sc.refresh() is True       # nothing new: no work


def test_vocab_growth_falls_back_to_full_rebuild():
    m = Machine()
    m.insert_keyword("he")
    sc = fresh_like(m)
    jsc = JaxScanner(m, n_streams=4, step_k=2)
    m.insert_keyword("ox")            # new letters: wider tables
    assert sc.refresh() is False and jsc.refresh() is False
    _same_tables(sc, jsc)
    assert_equiv(sc, m, "an ox and he and hex")


def test_capacity_growth_falls_back_to_full_rebuild():
    m = Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    assert sc._snap.cap == 1024
    m.insert_keyword("ab" * 700)      # 1,400 new states > capacity
    assert sc.refresh() is False
    assert sc._snap.cap >= m.n_states
    assert sc._snap.dflat.device == sc.device
    assert sc.count("xx abab yy") == 2


def test_count_bits_headroom_absorbs_small_growth():
    m = Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    assert sc._stepped.count_bits == 4
    m.insert_keyword("b")             # gram (a, b) now holds 2 matches
    assert sc.refresh() is True
    assert_equiv(sc, m, "ab b abab")


def test_count_bits_overflow_falls_back_to_full_rebuild():
    m = Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    bits = sc._stepped.count_bits
    for j in [0] + list(range(2, 16)):
        m.insert_keyword("a" * j + "b")
    assert sc.refresh() is False
    assert sc._stepped.count_bits > bits
    assert_equiv(sc, m, "a" * 20 + "b" + " ab b")


@pytest.mark.parametrize("step_k", [2, 3])
def test_halo_growth_rebinds_the_halo(step_k):
    """A keyword longer than the halo grows it (auto halo); the halo in
    gram steps follows, so block-spanning matches stay exact."""
    m = Machine()
    for w in ["he", "she"]:
        m.insert_keyword(w)
    sc = fresh_like(m, step_k=step_k)
    jsc = JaxScanner(m, n_streams=4, step_k=step_k)
    assert sc.halo == 2
    long_kw = "hehehehehehehehehehe"
    m.insert_keyword(long_kw)
    assert sc.refresh() is True and jsc.refresh() is True
    assert sc.halo == 24 and sc._halo_sym >= 24
    _same_tables(sc, jsc)
    text = ("x" * 37 + long_kw + "y" * 23) * 40
    fresh = assert_equiv(sc, m, text, step_k=step_k)
    host = m.match_stream(m.initiate(), text, parallel=False)
    assert sc.count(text) == host == fresh.count(text) == jsc.count(text)


@pytest.mark.parametrize("step_k", [2, 3])
def test_refresh_grows_the_warm_up_under_a_fixed_halo(step_k):
    """A user halo of 2 stays 2 when refresh() adds a keyword of 20
    letters, but the stepped kernels' warm-up (``_warm_steps``) follows
    the tables: the count equals the JAX scanner's at the same halo, and
    K3's host build, forced to 16 sub-streams a stream over the scanner's
    own layout and fields, equals the plain version per stream; with the
    warm-up from before the refresh it would lose the long keyword's
    matches that straddle a sub-stream's start. K4's warm-up
    (``_emit_warm``, a symbol longer) grows too: its host build at 16
    sub-streams writes the plain version's words, and with the stale
    warm-up it would not."""
    from aho_corasick_1975_tpu_torch.ops import build
    m = Machine()
    for w in ["he", "she"]:
        m.insert_keyword(w)
    sc = fresh_like(m, step_k=step_k, halo=2)
    jsc = JaxScanner(m, n_streams=4, step_k=step_k, halo=2)
    stale, stale_emit = sc._warm_steps, sc._emit_warm
    assert stale == 1 and stale_emit == -(-3 // step_k)
    long_kw = "hehehehehehehehehehe"
    m.insert_keyword(long_kw)
    assert sc.refresh() is True and jsc.refresh() is True
    assert sc.halo == jsc.halo == 2 and sc._halo_sym == jsc._halo_sym
    assert sc._warm_steps == -(-(len(long_kw) - 1) // step_k)
    assert sc._emit_warm == -(-len(long_kw) // step_k)
    text = ("x" * 37 + long_kw + "y" * 23) * 40
    assert sc.count(text) == jsc.count(text)
    st, snap = sc._stepped, sc._snap
    ids = sc.encode(text)
    B, L = sc._layout(len(ids), 128 * st.k)
    ext = np.zeros(sc._halo_sym + B * L, np.int32)
    ext[sc._halo_sym:sc._halo_sym + len(ids)] = ids
    ext = torch.from_numpy(ext)
    want = ms.stepped_count_plain(snap.packed, st.V, st.k, st.count_bits,
                                  sc._halo_steps, B, L, ext)
    assert int(want.sum()) == sc.count(text)
    lib = build.host_library()
    outs = []
    for warm in (sc._warm_steps, stale):
        out = torch.full((B,), -7, dtype=torch.int32)
        args = build.scan_args(
            table=snap.packed, ext=ext, out=out, L=L, Vk=st.Vk, B=B, V=st.V,
            halo=sc._halo_sym, k=st.k, count_bits=st.count_bits,
            warm_steps=warm, split=16)
        assert lib.ac_stepped_count(ctypes.byref(args), None) == 0
        outs.append(out)
    assert torch.equal(outs[0], want)
    assert int(outs[1].sum()) < int(want.sum())
    want_emit = hits.stepped_emit_plain(snap.packed, st.V, st.k,
                                        st.count_bits, sc._halo_steps, B, L,
                                        ext)
    emits = []
    for warm in (sc._emit_warm, stale_emit):
        got = (torch.full((B, L // st.k), -7, dtype=torch.int32),
               torch.full((B,), -7, dtype=torch.int32),
               torch.full((B,), -7, dtype=torch.int32))
        args = build.scan_args(
            table=snap.packed, ext=ext, out=got[0], n_hits=got[1],
            n_live=got[2], L=L, Vk=st.Vk, B=B, V=st.V, halo=sc._halo_sym,
            k=st.k, count_bits=st.count_bits, warm_steps=warm, split=16)
        assert lib.ac_stepped_emit(ctypes.byref(args), None) == 0
        emits.append(got)
    assert all(torch.equal(a, b) for a, b in zip(emits[0], want_emit))
    assert not torch.equal(emits[1][0], want_emit[0])


def test_refresh_grows_the_1char_warm_up_under_a_fixed_halo(monkeypatch):
    """A step_k=1 scanner (no stepped table) with a user halo of 2 derives
    the 1-char kernels' warm-up (``_warm_syms``) from the tables, and
    refresh() with a keyword of 20 letters grows it: count(),
    find_matches(max_hits=...) and a prefilter scanner's retrieval then
    equal the JAX scanner's, K1 and K8 get the new warm-up and the real
    rows, and K1's and K8's host builds, forced to 16 sub-streams a stream
    over the scanner's own layout, equal the plain versions; with the
    warm-up from before the refresh K1 loses the long keyword's matches
    that straddle a sub-stream's start."""
    from aho_corasick_1975_tpu_torch.models import scanner as port_scanner
    from aho_corasick_1975_tpu_torch.ops import build, hits, scan_dense
    seen = []

    def spy(fn):
        def run(*args, **kw):
            seen.append((fn.__name__, kw["warm_steps"], kw["n_states"]))
            return fn(*args, **kw)
        return run
    for name in ("dense_count", "dense_hits", "window_hits"):
        monkeypatch.setattr(port_scanner, name,
                            spy(getattr(port_scanner, name)))
    m = Machine()
    for w in ["he", "she"]:
        m.insert_keyword(w)
    sc = fresh_like(m, step_k=1, halo=2)
    scp = fresh_like(m, step_k=1, halo=2, prefilter="on")
    jsc = JaxScanner(m, n_streams=4, step_k=1, halo=2)
    jscp = JaxScanner(m, n_streams=4, step_k=1, halo=2, prefilter="on")
    assert sc._stepped is None and sc._warm_syms == 2
    stale = sc._warm_syms
    long_kw = "hehehehehehehehehehe"
    m.insert_keyword(long_kw)
    for s in (sc, scp, jsc, jscp):
        assert s.refresh() is True
    assert sc.halo == scp.halo == jsc.halo == 2
    assert sc._warm_syms == scp._warm_syms == len(long_kw) - 1
    text = ("x" * 37 + long_kw + "y" * 23) * 40
    n = sc.count(text)
    assert n == jsc.count(text)
    got, want = sc.find_matches(text, max_hits=n), jsc.find_matches(
        text, max_hits=n)
    sparse_text = "." * 5000 + long_kw + "." * 3000
    gotp, wantp = scp.find_matches(sparse_text), jscp.find_matches(
        sparse_text)
    for a, b in ((got, want), (gotp, wantp)):
        np.testing.assert_array_equal(a.ends, b.ends)
        np.testing.assert_array_equal(a.end_states, b.end_states)
        np.testing.assert_array_equal(a.indices, b.indices)
    assert len(gotp) > 0
    assert {s[0] for s in seen} == {"dense_count", "dense_hits",
                                    "window_hits"}
    assert {s[1:] for s in seen} == {(len(long_kw) - 1,
                                      sc.tables.n_states)}
    snap, V = sc._snap, sc.V
    ids = sc.encode(text)
    B, L = sc._layout(len(ids), 128)
    ext = np.zeros(sc.halo + B * L, np.int32)
    ext[sc.halo:sc.halo + len(ids)] = ids
    ext = torch.from_numpy(ext)
    args = (snap.dflat, snap.nb_out, V, sc.halo, B, L, ext)
    want_c = scan_dense.dense_count_plain(*args)
    want_h = hits.dense_hits_plain(*args)
    assert int(want_c.sum()) == n
    lib = build.host_library()
    fields = dict(table=snap.dflat, nb_out=snap.nb_out, ext=ext, L=L, B=B,
                  V=V, halo=sc.halo, n_states=sc.tables.n_states, split=16)
    outs = []
    for warm in (sc._warm_syms, stale):
        out = torch.full((B,), -7, dtype=torch.int32)
        args_c = build.scan_args(out=out, warm_steps=warm, **fields)
        assert lib.ac_dense_count(ctypes.byref(args_c), None) == 0
        outs.append(out)
    assert torch.equal(outs[0], want_c)
    assert int(outs[1].sum()) < n
    n_hits = torch.zeros(B * 16, dtype=torch.int32)
    n_pos = torch.zeros(B * 16, dtype=torch.int32)
    pass1 = build.scan_args(n_hits=n_hits, n_live=n_pos,
                            warm_steps=sc._warm_syms, **fields)
    assert lib.ac_dense_hits(ctypes.byref(pass1), None) == 0
    total = int(n_pos.sum())
    pos = torch.zeros(total, dtype=torch.int32)
    sts = torch.zeros(total, dtype=torch.int32)
    off = torch.cumsum(n_pos, 0, dtype=torch.int64) - n_pos
    pass2 = build.scan_args(hit_pos=pos, hit_state=sts, hit_off=off,
                            warm_steps=sc._warm_syms, **fields)
    assert lib.ac_dense_hits(ctypes.byref(pass2), None) == 0
    assert torch.equal(pos, want_h[0]) and torch.equal(sts, want_h[1])
    assert int(n_hits.sum()) == want_h[2] == n


def test_refresh_grows_the_k7_warm_up(monkeypatch):
    """A step_k=1 prefilter="on" scanner with a user halo of 2 counts
    sparse text through K7 dense's 1-char windows: host-encoded text as
    elided windows, a letter-id tensor over the device block filter's
    index list. refresh() with a keyword of 20 letters grows the warm-up
    K7 gets (``_warm_syms``, max_depth - 1 symbols) with the real rows,
    and both counts still equal the JAX scanner's."""
    from aho_corasick_1975_tpu_torch.ops import sparse
    seen = []
    real = sparse.sparse_count

    def spy(*args, **kw):
        seen.append((kw["warm_steps"], kw["n_states"], args[5].dim()))
        return real(*args, **kw)
    monkeypatch.setattr(sparse, "sparse_count", spy)
    m = Machine()
    for w in ["he", "she"]:
        m.insert_keyword(w)
    sc = fresh_like(m, step_k=1, halo=2, prefilter="on")
    jsc = JaxScanner(m, n_streams=4, step_k=1, halo=2, prefilter="on")
    long_kw = "hehehehehehehehehehe"
    text = "." * 5000 + long_kw + "." * 3000 + "she" + "." * 900
    assert sc.count(text) == jsc.count(text) == 12
    assert {s[0] for s in seen} == {2}
    m.insert_keyword(long_kw)
    assert sc.refresh() is True and jsc.refresh() is True
    assert sc._warm_syms == len(long_kw) - 1
    seen.clear()
    n = sc.count(text)
    assert n == jsc.count(text) == 13
    assert sc.count(torch.from_numpy(sc.encode(text))) == n
    assert {s[:2] for s in seen} == {(len(long_kw) - 1, sc.tables.n_states)}
    assert sorted({s[2] for s in seen}) == [1, 2]


@pytest.mark.parametrize("step_k", [2, 3])
def test_find_matches_after_refresh_uses_current_pk1(step_k):
    """The dense refinement's packed k=1 table is cached per dictionary
    version: after an in-place refresh, find_matches of a match-dense text
    equals a fresh scanner's."""
    rng = np.random.default_rng(3)
    m = Machine()
    m.insert_keyword("ab")
    m.insert_keyword("ba")
    sc = fresh_like(m, step_k=step_k)
    text = "".join(rng.choice(list("ab"), 3000))
    sc.find_matches(text)             # builds and caches pk1
    assert sc._pk1_cache is not None
    for w in ["aab", "bab", "abba", "b"]:
        m.insert_keyword(w)
    assert sc.refresh() is True
    fresh = fresh_like(m, step_k=step_k)
    got, want = sc.find_matches(text), fresh.find_matches(text)
    np.testing.assert_array_equal(got.ends, want.ends)
    np.testing.assert_array_equal(got.end_states, want.end_states)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert len(got) == sc.count(text) > 0


def test_refresh_fuzz_rounds_match_fresh_and_reference():
    rng = np.random.default_rng(7)
    alphabet = "abcd"
    m = Machine()
    m.insert_keyword(alphabet)        # pins the vocabulary
    sc = fresh_like(m)
    jsc = JaxScanner(m, n_streams=4, step_k=2)
    in_place = 0
    for _ in range(8):
        for _ in range(int(rng.integers(1, 6))):
            m.insert_keyword("".join(rng.choice(list(alphabet),
                                                int(rng.integers(1, 7)))))
        status = sc.refresh()
        assert status == jsc.refresh()
        in_place += status
        _same_tables(sc, jsc)
        text = "".join(rng.choice(list(alphabet + " "), 400))
        fresh = fresh_like(m)
        assert sc.count(text) == fresh.count(text) == jsc.count(text)
        np.testing.assert_array_equal(sc.scan_states(text),
                                      fresh.scan_states(text))
    assert in_place >= 6


def test_session_sees_refresh_from_next_chunk():
    m = Machine()
    m.insert_keyword("he")
    m.insert_keyword("hse")           # pins the vocabulary
    sc = fresh_like(m)
    s = sc.session()
    assert s.feed_count("he she") == 2
    m.insert_keyword("she")
    assert sc.refresh() is True
    assert s.feed_count(" she h") == 2
    assert s.feed_count("e") == 1     # 'he' across the chunk edge
    assert s.checkpoint()["version"] == m.version


def test_refresh_on_1char_path_without_stepped_tables():
    m = Machine()
    for w in ["he", "she", "hers"]:
        m.insert_keyword(w)
    sc = fresh_like(m, step_k=1)
    jsc = JaxScanner(m, n_streams=4, step_k=1)
    assert sc._stepped is None
    m.insert_keyword("hehe")
    assert sc.refresh() is True and jsc.refresh() is True
    _same_tables(sc, jsc)
    assert_equiv(sc, m, TEXT + " hehe", step_k=1)


def test_refresh_revalidates_the_raw_lut():
    """A keyword with byte 0 (ByteMachine id 1, the raw staging's pad)
    breaks the raw path's contract that raw 0 matches nothing: after the
    refresh the scanner must stop staging raw, or its padding matches. The
    JAX package keeps its LUT cache across refresh() (ROADMAP C9); the
    port re-validates it."""
    m = ByteMachine()
    m.insert_keyword(b"ab")
    sc = DenseScanner(m, device="cpu", n_streams=4)
    assert sc.count(b"xa") == 0 and sc._raw_stream(b"xa") is not None
    m.insert_keyword(b"a\x00")
    sc.refresh()
    assert sc._raw_stream(b"xa") is None
    for text in (b"xa", b"a\x00a", b"ab" * 300 + b"a"):
        assert sc.count(text) == m.match_stream(m.initiate(), text,
                                                parallel=False)
        assert len(sc.find_matches(text)) == sc.count(text)
    np.testing.assert_array_equal(sc.count_many([b"xa", b"a\x00"]), [0, 1])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _changed_rows(old, new) -> np.ndarray:
    """The JAX package's refresh's row diff (``models/snapshot.py:
    DeviceSnapshot.refresh``), restated: rows whose hop row or count
    changed, and every new row."""
    S_old = old.n_states
    changed = np.ones(new.n_states, bool)
    changed[:S_old] = (np.any(old.delta != new.delta[:S_old], axis=1)
                       | (old.nb_outputs != new.nb_outputs[:S_old]))
    return np.flatnonzero(changed)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_delta_cells_equal_reference(k):
    """The device derivation (``GramDelta`` on device="cpu") finds the JAX
    package's changed rows and its stepped_delta_cells' cells, landing
    states (int32) and counts (int64) element for element, reads their
    sizes and largest count in one ``sizes()``, and the cells it returns
    turn the old k-gram table into the new one."""
    rng = np.random.default_rng(11)
    alphabet = "abc"
    m = ac.Machine()
    m.insert_keyword(alphabet)
    old = m.compile()
    for _ in range(25):
        m.insert_keyword("".join(rng.choice(list(alphabet),
                                            int(rng.integers(1, 8)))))
    new = m.compile()
    delta = ms.GramDelta(_t(old.delta), _t(old.nb_outputs), _t(new.delta),
                         _t(new.nb_outputs), k)
    n_rows, n_cells, max_cnt = delta.sizes()
    rows = delta.rows()
    cells, land, cnt = delta.cells()
    want = jms.stepped_delta_cells(old, new, k)
    np.testing.assert_array_equal(rows.numpy(), _changed_rows(old, new))
    assert (n_rows, n_cells, max_cnt) == (len(rows), len(want[0]),
                                          int(want[2].max()))
    assert land.dtype == torch.int32 and cnt.dtype == torch.int64
    for got, w in zip((cells, land, cnt), want):
        np.testing.assert_array_equal(got.numpy(), w)
    cells, land, cnt = cells.numpy(), land.numpy(), cnt.numpy()
    d_old, c_old = jms.compose_rows(old.delta, old.nb_outputs,
                                    np.arange(old.n_states), k)
    d_new, c_new = jms.compose_rows(new.delta, new.nb_outputs,
                                    np.arange(new.n_states), k)
    d_app = np.full_like(d_new, -7)
    c_app = np.full_like(c_new, -7)
    d_app[:old.n_states] = d_old
    c_app[:old.n_states] = c_old
    d_app.reshape(-1)[cells] = land
    c_app.reshape(-1)[cells] = cnt
    np.testing.assert_array_equal(d_app, d_new)
    np.testing.assert_array_equal(c_app, c_new)
    # the largest count comes from a DP over the masks, not the cells:
    # many small growths reach its rarer branches
    for seed in range(300):
        rng = np.random.default_rng(seed)

        def word():
            return "".join(rng.choice(list(alphabet),
                                      int(rng.integers(1, 6))))
        m = ac.Machine()
        for _ in range(int(rng.integers(1, 6))):
            m.insert_keyword(word())
        old = m.compile()
        for _ in range(int(rng.integers(1, 3))):
            m.insert_keyword(word())
        new = m.compile()
        if new.vocab_size != old.vocab_size:
            continue
        want = jms.stepped_delta_cells(old, new, k)
        assert ms.GramDelta(_t(old.delta), _t(old.nb_outputs),
                            _t(new.delta), _t(new.nb_outputs),
                            k).sizes() == (
            len(_changed_rows(old, new)), len(want[0]),
            int(want[2].max()) if len(want[2]) else 0)


@pytest.mark.parametrize("form", ["packed_k1", "two_table", "mesh"])
def test_inplace_refresh_on_device_equals_reference(form, monkeypatch):
    """Test 3's shape class: random 7-letter keywords, then more of them,
    a growth that stays under the capacity, so the refresh goes in place.
    The packed k = 1 table of a DenseScanner (Test 3's own form), the
    two-table form (forced, at k = 2) and a mesh's snapshot on two
    distinct CPU devices (a replica each): the refresh writes its rows and
    cells, as many as the JAX package's row diff and stepped_delta_cells
    find, and every replica's tables then equal a fresh snapshot's bit for
    bit, and the scanner counts as a fresh one."""
    from aho_corasick_1975_tpu_torch.parallel.mesh import make_mesh
    from aho_corasick_1975_tpu_torch.parallel.sharded_scan import \
        ShardedScanner
    rng = np.random.default_rng(23)

    def words(n):
        return ["".join(chr(97 + c) for c in rng.integers(0, 26, 7))
                for _ in range(n)]
    spec = dict(step_k="auto", step_budget_bytes=4 << 20)
    n0, n1 = 3000, 150
    if form == "two_table":
        monkeypatch.setattr(ms, "packed_count_bits", lambda max_cnt, S: None)
        spec, n0, n1 = dict(step_k=2), 600, 40

    def scanner(m):
        if form == "mesh":
            return ShardedScanner(m, make_mesh(devices=["cpu:0", "cpu:1"]),
                                  n_streams_per_device=4, **spec)
        return DenseScanner(m, device="cpu", n_streams=4, **spec)
    m = Machine()
    m.insert_keywords(words(n0))
    sc = scanner(m)
    old = sc._snap.tables
    online = words(n1)
    m.insert_keywords(online)
    assert sc.refresh() is True
    snap, new = sc._snap, m.compile()
    assert snap.tables.version == new.version and new.n_states > old.n_states
    k = 2 if form == "two_table" else 1
    assert snap.step_k == k and (snap.delta_k is not None) == (
        form == "two_table")
    assert snap.last_refresh["rows"] == len(_changed_rows(old, new))
    assert snap.last_refresh["cells"] == len(
        jms.stepped_delta_cells(old, new, k)[0]) > 0
    fresh = scanner(m)
    assert len(snap.devices) == (2 if form == "mesh" else 1)
    for d in snap.devices:
        for name, t in snap.replica(d).items():
            want = getattr(fresh._snap, name)
            assert (t is None) == (want is None), name
            if t is not None:
                # the capacity is the old version's: the rows past the
                # fresh snapshot's are padding, zero in both
                n = min(len(t), len(want))
                assert torch.equal(t[:n], want[:n]), (d, name)
                assert not t[n:].any() and not want[n:].any()
    text = " ".join(online[::3] + words(200))
    host = m.match_stream(m.initiate(), text, parallel=False)
    assert sc.count(text) == fresh.count(text) == host > 0


def test_refresh_under_concurrent_scans():
    """Threads scan one scanner while the main thread inserts keywords and
    refreshes it, in place and through a rebuild (a new letter): every
    count and every match set's length must be one of a whole snapshot's
    (the two are equal for each), never a mix of old and new tables or
    LUTs."""
    import random
    import sys
    import threading

    stages = [["ab", "ba"], ["aab", "bab"], ["abba", "b"], ["cab", "bb"]]
    rng = random.Random(5)
    text = "".join(rng.choice("abc ") for _ in range(3000))
    want, m = set(), Machine()
    for batch in stages:
        for w in batch:
            m.insert_keyword(w)
        fresh = fresh_like(m)
        want.add(fresh.count(text))
        assert len(fresh.find_matches(text)) in want
    m = Machine()
    for w in stages[0]:
        m.insert_keyword(w)
    sc = fresh_like(m)
    got, errors, stop = [], [], threading.Event()

    def scan():
        try:
            while not stop.is_set():
                got.append(sc.count(text))
                got.append(len(sc.find_matches(text)))
        except Exception as e:     # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=scan) for _ in range(6)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for batch in stages[1:]:
            for w in batch:
                m.insert_keyword(w)
            sc.refresh()
        stop.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got and set(got) <= want, set(got) - want
    assert sc.count(text) == len(sc.find_matches(text)) == max(want)
