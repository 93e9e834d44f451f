"""The snapshot's k-gram table, composed on its device from the uploaded
1-char tables (CPU tensors here), against the JAX package's
``build_stepped``: bit for bit at capacity, packed with the same
``count_bits`` and k, or in two tables where the packed entry is forced
too wide, in one row block or several; after a rebuild for capacity,
vocabulary or count width; the span note that says where the table was
made; and the dense refinement's packed k=1 table
(``DenseScanner._pk1``)."""

from __future__ import annotations

import random

import numpy as np
import pytest

from aho_corasick_1975_tpu.ops import multistep as jms
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.core.builder import round_cap
from aho_corasick_1975_tpu_torch.models.snapshot import DeviceSnapshot
from aho_corasick_1975_tpu_torch.ops import multistep as ms
from aho_corasick_1975_tpu_torch.utils import profiling

WORDS = ("the of and to in is was he for it with as his on be at by had "
         "not are but from or have an they which one you were her all she "
         "there would their we him been has when who will more no if out "
         "so said what up its about into than them can only other new some "
         "could time these two may then do first any my now such like our "
         "over man me even most made after also did many before must through "
         "back years where much your way well down should because each just "
         "those people how too little state good very make world still own "
         "see men work long get here between both life being under never "
         "day same another know while last might us great old year off come "
         "since against go came right used take three hers ushers").split()


def _machine(words) -> Machine:
    m = Machine()
    for w in words:
        m.insert_keyword(w)
    return m


def _random7(n: int = 500, letters: str = "abcdefghij", seed: int = 7):
    """Test 3's random 7-letter keywords, over fewer letters so that V^3
    stays small: a few thousand states."""
    rng = random.Random(seed)
    return ["".join(rng.choice(letters) for _ in range(7)) for _ in range(n)]


def _edge(k: int):
    """a, aa, ..., a^n with n = 16 // k: the gram of k a's from a^n holds
    n*k matches, 16 at k = 1 and 2 (one past 4 bits) and 15 at k = 3 (all
    4 bits), beside a few words that hold fewer."""
    return ["a" * j for j in range(1, 16 // k + 1)] + ["b", "ab", "ba", "bab"]


DICTS = {"words": lambda k: WORDS, "random7": lambda k: _random7(),
         "edge": _edge}


def _host_max(t, k: int) -> int:
    """build_stepped's DP on the host."""
    h = np.zeros(t.n_states, np.int64)
    for _ in range(k):
        h = (t.nb_outputs[t.delta] + h[t.delta]).max(axis=1)
    return int(h.max())


def _unpacked(orig):
    """The JAX package's build_stepped, its table returned unpacked."""
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


def _two_table_width(monkeypatch):
    """The port's packed entry reads as too wide: the two-table form."""
    monkeypatch.setattr(ms, "packed_count_bits", lambda max_cnt, S: None)


def _snapshot(t, k: int) -> DeviceSnapshot:
    """A snapshot at k; at k = 1 one of the 1-char tables alone, whose
    packed table is then composed (as "auto" does where it fits), or, at
    the two-table width, its two tables (which no snapshot keeps at k =
    1)."""
    snap = DeviceSnapshot(t, step_k=k, device="cpu")
    if k == 1:
        assert snap.stepped is None
        if not snap._compose(1):
            snap.delta_k, snap.cnt_k = ms.compose_two_tables(
                snap.dflat.view(snap.cap, snap.V), snap.nb_out, t.n_states,
                1, snap.cap)
            snap.stepped = ms.SteppedTables(k=1, V=snap.V, count_bits=0)
    return snap


def _at_cap(table: np.ndarray, cap: int, Vk: int) -> np.ndarray:
    out = np.zeros(cap * Vk, np.int32)
    out[:table.size] = table
    return out


def _same_as_host(snap, k: int):
    """The snapshot's tables equal the JAX package's build_stepped at its
    capacity: packed, or forced unpacked for the two-table form."""
    t = snap.tables
    assert (snap.step_k, snap.stepped.k) == (k, k)
    if snap.packed is not None:
        st = jms.build_stepped(t, k, cap_rows=snap.cap)
        assert st.packed is not None and snap.delta_k is None
        assert snap.stepped.count_bits == st.count_bits
        np.testing.assert_array_equal(snap.packed.numpy(), st.cap_packed)
    else:
        st = _unpacked(jms.build_stepped)(t, k)
        assert snap.stepped.count_bits == st.count_bits == 0
        for name in ("delta_k", "cnt_k"):
            np.testing.assert_array_equal(
                getattr(snap, name).numpy(),
                _at_cap(getattr(st, name), snap.cap, st.Vk))
    dflat = np.zeros((snap.cap, snap.V), np.int32)
    dflat[:t.n_states] = t.delta
    np.testing.assert_array_equal(snap.dflat.numpy(), dflat.reshape(-1))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(DICTS))
@pytest.mark.parametrize("form", ["packed", "two_table"])
def test_composed_table_is_build_stepped(monkeypatch, form, kind, k):
    if form == "two_table":
        _two_table_width(monkeypatch)
    t = _machine(DICTS[kind](k)).compile()
    snap = _snapshot(t, k)
    assert (snap.packed is None) == (form == "two_table")
    delta = snap.dflat.view(snap.cap, snap.V)
    got = ms.max_gram_count(delta, snap.nb_out, t.n_states, k)
    assert got == _host_max(t, k)
    if kind == "edge":
        assert got == (16 // k) * k
    _same_as_host(snap, k)


def test_auto_composes_the_packed_1char_table():
    """step_k="auto" where only k = 1 fits the budget (Test 3's case):
    the packed k=1 table, composed beside the 1-char tables."""
    t = _machine(_random7()).compile()
    cap, V = round_cap(t.n_states), t.vocab_size
    assert t.n_states * V * V * 4 > cap * V * 4
    snap = DeviceSnapshot(t, step_k="auto", step_budget_bytes=cap * V * 4,
                          device="cpu")
    _same_as_host(snap, 1)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_composed_in_row_blocks(monkeypatch, k):
    """Several row blocks (seven rows each, the last one short) compose
    the table one block does."""
    t = _machine(_random7(120)).compile()
    monkeypatch.setattr(ms, "COMPOSE_BLOCK_BYTES", 8 * t.vocab_size ** k * 7)
    assert t.n_states % 7
    snap = _snapshot(t, k)
    assert ms.max_gram_count(snap.dflat.view(snap.cap, snap.V), snap.nb_out,
                             t.n_states, k) == _host_max(t, k)
    _same_as_host(snap, k)


def _grow(reason: str, m: Machine) -> None:
    """Insertions that make the next refresh rebuild for ``reason``
    (tests/test_torch_refresh.py's cases)."""
    if reason == "cap":
        m.insert_keyword("ab" * 700)
    elif reason == "vocab":
        m.insert_keyword("ox")
    else:
        for j in [0] + list(range(2, 16)):
            m.insert_keyword("a" * j + "b")


@pytest.mark.parametrize("reason", ["cap", "vocab", "count_bits"])
def test_rebuild_equals_a_fresh_build(reason):
    m = _machine(["ab"])
    snap = DeviceSnapshot(m.compile(), step_k=2, device="cpu")
    _grow(reason, m)
    new = m.compile()
    assert snap.refresh(new) == f"rebuild:{reason}"
    _same_as_host(snap, 2)
    fresh = DeviceSnapshot(m.compile(), step_k=2, device="cpu")
    assert snap.cap == fresh.cap
    assert snap.stepped.count_bits == fresh.stepped.count_bits
    np.testing.assert_array_equal(snap.packed.numpy(), fresh.packed.numpy())


def _build_note(**kw) -> tuple:
    """A snapshot of the word dictionary at k = 2, and the counts of its
    one ``ac.snapshot.build`` span."""
    t = _machine(WORDS).compile()
    profiling.reset()
    with profiling.tracing():
        snap = DeviceSnapshot(t, step_k=2, device="cpu", **kw)
    recs = [r for r in profiling.records() if r["name"] == "ac.snapshot.build"]
    assert len(recs) == 1
    return snap, recs[0]["counts"]


@pytest.mark.parametrize("form", ["packed", "two_table", "none"])
def test_the_build_notes_where_it_composed(monkeypatch, form):
    """Either form of the table is composed on the device, the two-table
    width (forced) too, and none is kept with ``packed_only``; no host
    composer is left in the port."""
    assert not any(hasattr(ms, f) for f in
                   ("build_stepped", "pack", "compose_rows"))
    if form != "packed":
        _two_table_width(monkeypatch)
    snap, counts = _build_note(packed_only=form == "none")
    assert counts["k"] == 2
    assert counts["compose"] == ("none" if form == "none" else "device")
    if form == "none":
        assert snap.stepped is None and snap.packed is None
        assert snap.delta_k is None and snap.cnt_k is None
    else:
        assert (snap.packed is None) == (form == "two_table")
        _same_as_host(snap, 2)


@pytest.mark.parametrize("kind", sorted(DICTS))
def test_pk1_is_the_packed_1char_table(kind):
    """The dense refinement's k=1 table, composed on the device at k = 2,
    equals the JAX package's k=1 composition packed at cb1, and again
    after an in-place refresh."""
    m = _machine(DICTS[kind](2))
    sc = DenseScanner(m, n_streams=4, step_k=2, device="cpu")
    for _ in range(2):
        t = sc.tables
        pk1, cb1 = sc._pk1()
        assert cb1 == max(1, int(t.nb_outputs.max()).bit_length())
        d, cnt = jms.compose_rows(t.delta, t.nb_outputs,
                                  np.arange(t.n_states), 1)
        np.testing.assert_array_equal(
            pk1.numpy(),
            ((d.astype(np.int64) << cb1) | cnt).astype(np.int32).ravel())
        m.insert_keyword("abba")
        m.insert_keyword("bba")
        assert sc.refresh() is True
