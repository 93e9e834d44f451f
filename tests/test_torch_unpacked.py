"""The two-table k-gram form (K9) against the JAX scanner's.

Where (state, count) need more than 31 bits the k-gram table is kept as two
int32 tables, ``delta_k`` and ``cnt_k``. Small automata never need it, so
the tests force it: the JAX package's ``build_stepped`` is wrapped, as
tests/test_multistep.py, test_refresh.py and test_count_many.py do, to
return its table unpacked, and the port's ``packed_count_bits`` reports
the packed entry too wide, so that its snapshot composes the two tables
on its device. Then the port's snapshot must hold the JAX snapshot's k
and tables bit for bit, and count, count_many, find_matches,
the prefilter and refresh must equal the JAX scanner's. Exact throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.ops import multistep as pms
from aho_corasick_1975_tpu_torch.utils.convert import snapshot_from_jax


def _unpacked(orig):
    def build_stepped(tables, k, cap_rows=None):
        st = orig(tables, k)
        if st.packed is not None:
            cb = st.count_bits
            st.delta_k = (st.packed >> cb).astype(np.int32)
            st.cnt_k = (st.packed & ((1 << cb) - 1)).astype(np.int32)
            st.packed = None
            st.cap_packed = None
            st.count_bits = 0
        return st
    return build_stepped


@pytest.fixture(autouse=True)
def _force_unpacked(monkeypatch):
    monkeypatch.setattr(jms, "build_stepped", _unpacked(jms.build_stepped))
    monkeypatch.setattr(pms, "packed_count_bits", lambda max_cnt, S: None)


def _pair(seed=0, n=40, alpha=b"abcd"):
    rng = random.Random(seed)
    jm, pm = ac.Machine(), Machine()
    for _ in range(n):
        w = bytes(rng.choice(alpha) for _ in range(rng.randint(1, 6)))
        jm.insert_keyword(w)
        pm.insert_keyword(w)
    return jm, pm


def _text(seed, n=3000, alpha=b"abcdx "):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alpha, np.uint8), n).tobytes()


def _same_snapshot(sc, jsc):
    assert sc.step_k == jsc.step_k
    st, jst = sc._stepped, jsc._stepped
    assert st is not None and jst.packed is None and sc._snap.packed is None
    assert (st.k, st.count_bits) == (jst.k, jst.count_bits)
    np.testing.assert_array_equal(sc._snap.delta_k.numpy(),
                                  np.asarray(jsc._st_dev[0]))
    np.testing.assert_array_equal(sc._snap.cnt_k.numpy(),
                                  np.asarray(jsc._st_dev[1]))
    np.testing.assert_array_equal(sc._snap.dflat.numpy(),
                                  np.asarray(jsc._dflat))


@pytest.mark.parametrize("step_k", ["auto", 2, 3])
def test_snapshot_is_the_reference_snapshot(step_k):
    jm, pm = _pair()
    jsc = jm.scanner(n_streams=8, step_k=step_k)
    sc = pm.scanner(n_streams=8, step_k=step_k, device="cpu")
    _same_snapshot(sc, jsc)


@pytest.mark.parametrize("step_k", ["auto", 2, 3])
def test_counts_equal_reference(step_k):
    jm, pm = _pair(1)
    jsc = jm.scanner(n_streams=8, step_k=step_k)
    sc = pm.scanner(n_streams=8, step_k=step_k, device="cpu")
    text = _text(2)
    ids = jsc.encode(text)
    head = ids[:4]
    for signs in (text, np.frombuffer(text, np.uint8), ids):
        assert sc.count(signs) == jsc.count(signs) > 0
        assert sc.count(signs, head=head) == jsc.count(signs, head=head)
    t = torch.from_numpy(ids)
    assert sc.count(t) == jsc.count(jnp.asarray(ids))
    assert sc.count(t, head=head) == jsc.count(jnp.asarray(ids), head=head)
    s, js = sc.session(), jsc.session()
    for i in range(0, len(text), 333):
        assert s.feed_count(text[i:i + 333]) == js.feed_count(text[i:i + 333])


@pytest.mark.parametrize("step_k", [2, 3])
def test_count_many_equals_reference(step_k):
    jm, pm = _pair(2)
    jsc = jm.scanner(n_streams=8, step_k=step_k)
    sc = pm.scanner(n_streams=8, step_k=step_k, device="cpu")
    rng = random.Random(3)
    docs = [_text(rng.randint(0, 99), rng.randint(0, 900)) for _ in range(11)]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))
    assert sc.stats["last_op"] == "count_many"
    for L in (768, 513):   # a multiple of k (K9's batch form), and not
        tm = np.zeros((L, len(docs)), np.int32)
        for j, d in enumerate(docs):
            e = jsc.encode(d)[:L]
            tm[:len(e), j] = e
        np.testing.assert_array_equal(sc.count_many(torch.from_numpy(tm)),
                                      jsc.count_many(jnp.asarray(tm)))


def test_find_matches_and_prefilter_equal_reference():
    jm, pm = _pair(4)
    jsc = jm.scanner(n_streams=8, step_k=2)
    sc = pm.scanner(n_streams=8, step_k=2, device="cpu")
    text = _text(5)
    for a, b in ((sc.find_matches(text), jsc.find_matches(text)),
                 (sc.find_matches(text, max_hits=4000),
                  jsc.find_matches(text, max_hits=4000))):
        np.testing.assert_array_equal(a.ends, b.ends)
        np.testing.assert_array_equal(a.end_states, b.end_states)
        np.testing.assert_array_equal(a.indices, b.indices)
    sparse = bytes(20_000) + text[:200] + bytes(9_000)
    jsp = jm.scanner(n_streams=8, step_k=2, prefilter="on")
    sp = pm.scanner(n_streams=8, step_k=2, prefilter="on", device="cpu")
    assert sp._sparse_geometry() == (1, sp.halo, 128)
    ids = jsp.encode(sparse)
    for signs, jsigns in ((sparse, sparse), (ids, ids),
                          (torch.from_numpy(ids), jnp.asarray(ids))):
        assert sp.count(signs) == jsp.count(jsigns) > 0
        assert sp.stats.get("sparse_live_frac") == \
            jsp.stats.get("sparse_live_frac")


def test_refresh_rounds_equal_reference():
    jm, pm = _pair(6)
    jsc = jm.scanner(n_streams=8, step_k=2, step_budget_bytes=1 << 30)
    sc = pm.scanner(n_streams=8, step_k=2, step_budget_bytes=1 << 30,
                    device="cpu")
    text = _text(7)
    rng = random.Random(8)
    in_place = 0
    for _ in range(4):
        for _ in range(rng.randint(1, 4)):
            w = bytes(rng.choice(b"abcdx") for _ in range(rng.randint(1, 6)))
            jm.insert_keyword(w)
            pm.insert_keyword(w)
        status = sc.refresh()
        assert status == jsc.refresh()
        in_place += status and sc._snap.last_refresh.get("cells", 0) > 0
        _same_snapshot(sc, jsc)
        assert sc.count(text) == jsc.count(text)
    assert in_place >= 2   # the cell scatter into both tables ran


def test_engines_over_the_two_tables_equal_reference(monkeypatch):
    """With the two tables, engine="mxu" counts raw input through its raw
    form, as the JAX scanner does (the two-table count alone falls back
    to host ids). engine="hybrid" needs the packed table: the JAX scanner
    quietly counts through the two tables, the port raises (ROADMAP
    C10)."""
    from aho_corasick_1975_tpu_torch.ops import scan_mxu
    jm, pm = _pair(11)
    jsc = jm.scanner(n_streams=8, step_k=2, engine="mxu")
    sc = pm.scanner(n_streams=8, step_k=2, engine="mxu", device="cpu")
    assert sc._two_table and jsc._stepped.packed is None
    forms = []
    orig = scan_mxu.mxu_count

    def spy(*args, **kw):
        forms.append("ids" if args[8] is None else "raw")
        return orig(*args, **kw)
    monkeypatch.setattr(scan_mxu, "mxu_count", spy)
    text = _text(12, 1500)
    assert sc.count(text) == jsc.count(text) > 0
    assert forms == ["raw"]
    ids = jsc.encode(text)
    assert sc.count(torch.from_numpy(ids)) == jsc.count(jnp.asarray(ids))
    docs = [text[:700], text[700:], b""]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))
    assert jm.scanner(n_streams=8, step_k=2, engine="hybrid")._hybrid is None
    with pytest.raises(ValueError, match="hybrid"):
        pm.scanner(n_streams=8, step_k=2, engine="hybrid", device="cpu")


def test_snapshot_from_jax_carries_the_two_tables():
    jm, pm = _pair(9)
    jsc = jm.scanner(n_streams=8, step_k=3)
    snap = snapshot_from_jax(jsc, device="cpu")
    sc = DenseScanner(pm, device="cpu", halo=jsc.halo, snapshot=snap,
                      n_streams=8)
    _same_snapshot(sc, jsc)
    own = pm.scanner(n_streams=8, step_k=3, device="cpu")
    _same_snapshot(own, jsc)
    text = _text(10)
    assert sc.count(text) == own.count(text) == jsc.count(text) > 0
