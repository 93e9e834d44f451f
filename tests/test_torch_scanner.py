"""The port's scanner (device="cpu", where every kernel wrapper takes its
plain version) against the JAX scanner on one Machine and one input.

Counts must be equal and MatchSets equal element for element (ends,
end_states, indices). The port runs on its own snapshot and on the JAX
scanner's tables carried across (utils/convert.py). Inputs are made from
seeds.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.utils.convert import snapshot_from_jax

GOLDEN = "To ushers: he found his pencil, but she could not find hers."
GOLDEN_LINE = " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"


def _machine(seed=0, n=60, alpha=b"abc"):
    rng = random.Random(seed)
    m = Machine()
    for i in range(n):
        m.insert_keyword(bytes(rng.choice(alpha)
                               for _ in range(rng.randint(1, 6))), value=i)
    return m


def _text(seed, n=20_000, alpha=b"abcx "):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alpha, np.uint8), n).tobytes()


def _pair(m, via="own", **kw):
    """(JAX scanner, port scanner) over machine m, the port on its own
    snapshot or on the JAX tables."""
    jsc = JaxScanner(m, **kw)
    if via == "own":
        return jsc, DenseScanner(m, device="cpu", **kw)
    snap = snapshot_from_jax(jsc, device="cpu")
    sc = DenseScanner(m, device="cpu", halo=jsc.halo, snapshot=snap,
                      **{k: v for k, v in kw.items() if k == "n_streams"})
    assert (sc._halo_steps, sc._halo_sym) == (jsc._halo_steps, jsc._halo_sym)
    return jsc, sc


def _same(a, b):
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.end_states, b.end_states)
    np.testing.assert_array_equal(a.indices, b.indices)


def _golden_line(ms):
    """The reference demo's line: per end position, shortest match
    first."""
    ev = sorted(ms, key=lambda e: (e[0].end, -e[0].index))
    return "".join(f" {e.start + 1}:{mt.text()}" for e, mt in ev)


@pytest.mark.parametrize("step_k", ["auto", 1, 2, 3])
@pytest.mark.parametrize("via", ["own", "jax"])
def test_count_and_matches(via, step_k):
    m = _machine()
    jsc, sc = _pair(m, via, n_streams=8, step_k=step_k)
    assert sc.step_k == jsc.step_k
    text = _text(1)
    ids = m.vocab.lookup_many(text)
    head = ids[:5]
    cases = [text, text.decode(), np.frombuffer(text, np.uint8),
             np.asarray(ids, np.int32)]
    for signs in cases:
        # a str is codepoints, which no byte keyword matches
        assert sc.count(signs) == jsc.count(signs) > -isinstance(signs, str)
        assert sc.count(signs, head=head) == jsc.count(signs, head=head)
        _same(sc.find_matches(signs), jsc.find_matches(signs))
        _same(sc.find_matches(signs, offset=3, head=head),
              jsc.find_matches(signs, offset=3, head=head))
    t_ids = torch.from_numpy(np.asarray(ids, np.int64))
    assert sc.count(t_ids) == jsc.count(jnp.asarray(ids)) > 0
    assert sc.count(t_ids, head=head) == jsc.count(jnp.asarray(ids),
                                                   head=head)
    _same(sc.find_matches(t_ids), jsc.find_matches(jnp.asarray(ids)))
    np.testing.assert_array_equal(sc.scan_states(text), jsc.scan_states(text))
    np.testing.assert_array_equal(sc.scan_states(t_ids, head=head),
                                  jsc.scan_states(jnp.asarray(ids),
                                                  head=head))


@pytest.mark.parametrize("step_k", ["auto", 1, 3])
def test_str_keywords(step_k):
    """A str machine: str input takes the codepoint LUT."""
    rng = random.Random(10)
    m = Machine()
    for _ in range(50):
        m.insert_keyword("".join(rng.choice("aβc")
                                 for _ in range(rng.randint(1, 5))))
    jsc, sc = _pair(m, n_streams=8, step_k=step_k)
    text = "".join(rng.choice("aβcx€ ") for _ in range(10_000))
    assert sc._raw_stream(text) is not None
    assert sc.count(text) == jsc.count(text) > 0
    _same(sc.find_matches(text), jsc.find_matches(text))


@pytest.mark.parametrize("step_k", [1, 2, 3])
def test_max_hits(step_k):
    m = _machine(2)
    jsc, sc = _pair(m, n_streams=8, step_k=step_k)
    text = _text(3, 4000)
    full = jsc.find_matches(text)
    n_pos = len(np.unique(full.ends))
    _same(sc.find_matches(text, max_hits=n_pos),
          jsc.find_matches(text, max_hits=n_pos))
    for bound in (n_pos - 1, 5):
        with pytest.raises(ValueError, match="max_hits"):
            jsc.find_matches(text, max_hits=bound)
        with pytest.raises(ValueError, match="max_hits"):
            sc.find_matches(text, max_hits=bound)


@pytest.mark.parametrize("density", ["sparse", "dense"])
def test_refinement_paths(density):
    """Both phase-B refinements: live-gram compaction on a sparse corpus,
    every-position refinement (pk1) past 1/8 live grams."""
    m = _machine(4, alpha=b"ab")
    jsc, sc = _pair(m, n_streams=16, step_k=3)
    alpha = b"abyz" + b"z" * 60 if density == "sparse" else b"ab"
    text = _text(5, 30_000, alpha)
    got, want = sc.find_matches(text), jsc.find_matches(text)
    _same(got, want)
    assert len(got) == sc.count(text) > 0


def test_pipelined_chunks(monkeypatch):
    for cls in (DenseScanner, JaxScanner):
        monkeypatch.setattr(cls, "_pipeline_min", 20_000)
        monkeypatch.setattr(cls, "_pipeline_chunk", 8_192)
    m = _machine(6)
    text = bytearray(_text(7, 50_000))
    for i in (1, 2, 3):        # a keyword across every chunk edge
        text[i * 8192 - 2:i * 8192 + 2] = b"abca"
    text = bytes(text)
    head = m.vocab.lookup_many(b"ab")
    for step_k in (1, 3):
        jsc, sc = _pair(m, n_streams=4, step_k=step_k)
        # the JAX package's pipelined count of a scanner without a packed
        # table fails (ROADMAP C.7): compare with its single launch
        for signs in (text, text.decode()):
            for h in (None, head):
                want = jsc._count_raw(*jsc._raw_stream(signs), h)
                assert sc.count(signs, head=h) == want
        oracle = m.match_stream(m.initiate(), text, parallel=False)
        assert sc.count(text) == oracle > 0
        assert sc.count(text, head=head) == m.match_stream(
            m.initiate(), b"ab" + text, parallel=False) - m.match_stream(
                m.initiate(), b"ab")


def test_golden_example():
    m = Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    for step_k in ("auto", 1):
        sc = m.scanner(device="cpu", step_k=step_k)
        assert sc.count(GOLDEN) == 9
        assert _golden_line(sc.find_matches(GOLDEN)) == GOLDEN_LINE


def test_empty_and_oov():
    m = _machine()
    jsc, sc = _pair(m, n_streams=8)
    assert sc.count(b"") == sc.count("") == 0
    assert len(sc.find_matches(b"")) == 0
    assert sc.scan_states(b"").shape == (0,)
    assert sc.count(torch.zeros(0, dtype=torch.int32)) == 0
    oov = "xyzé€ " * 300      # no keyword letters at all, non-ASCII too
    assert sc.count(oov) == jsc.count(oov) == 0
    mixed = ("abc€ab\U0001F600cab" * 200).encode()
    assert sc.count(mixed) == jsc.count(mixed) > 0
    _same(sc.find_matches(mixed), jsc.find_matches(mixed))


def test_letters_after_snapshot_are_oov():
    m = _machine()
    jsc, sc = _pair(m, n_streams=8)
    m.insert_keyword(b"q")            # a new letter, after both snapshots
    text = _text(8, 5000, b"abcq")
    assert sc.count(text) == jsc.count(text) > 0
    ids = np.asarray(m.vocab.lookup_many(text), np.int32)
    with pytest.raises(ValueError):
        sc.count(ids)                 # id of q is >= the snapshot's V
    _same(sc.find_matches(text), jsc.find_matches(text))


def test_tensor_ids_are_validated():
    m = _machine()
    sc = DenseScanner(m, device="cpu", n_streams=8)
    for bad in (torch.tensor([0, 1, sc.V]), torch.tensor([1, -1, 2]),
                torch.tensor([0.0, 1.0]), torch.zeros((2, 2),
                                                      dtype=torch.int32)):
        for fn in (sc.count, sc.find_matches, sc.scan_states):
            with pytest.raises(ValueError):
                fn(bad)
    with pytest.raises(ValueError):
        sc.count(b"abc", head=[sc.V])


def test_tables_carried_from_jax_equal_own():
    m = _machine(9)
    jsc, own = _pair(m, n_streams=8)
    conv = _pair(m, "jax", n_streams=8)[1]
    assert torch.equal(own._snap.dflat, conv._snap.dflat)
    assert torch.equal(own._snap.nb_out, conv._snap.nb_out)
    assert torch.equal(own._snap.packed, conv._snap.packed)
    assert own._stepped.count_bits == conv._stepped.count_bits


def test_unported_options_raise():
    """The options that raised before the engines were ported now build
    scanners that count as the gather engine does
    (tests/test_torch_engines.py holds them against the JAX scanner); an
    unknown engine still raises."""
    m = _machine()
    text = _text(4, 2000)
    want = DenseScanner(m, device="cpu", n_streams=8).count(text)
    for kw in (dict(engine="mxu"), dict(engine="hybrid")):
        assert DenseScanner(m, device="cpu", n_streams=8,
                            **kw).count(text) == want > 0
    with pytest.raises(ValueError):
        DenseScanner(m, device="cpu", engine="warp")
    ref = ac.Machine()
    ref.insert_keyword("ab")
    sc = DenseScanner(ref, device="cpu")       # a JAX-package Machine too
    assert sc.count("abab") == 2
