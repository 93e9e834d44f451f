"""The port's StreamSession (device="cpu") against the JAX package's.

The same seeded chunks go through a port session and a JAX session over one
Machine: per-chunk counts, per-chunk MatchSets (ends, end_states, indices),
tails and checkpoints must be equal, and the totals equal one count() of
the whole stream. Cut points fall inside keywords and chunks are shorter
than the halo. Recovery goes through the port's save_machine/load_machine
as tests/test_failure_recovery.py does through the JAX package's.
"""

import io
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu.models.scanner import \
    StreamSession as JaxSession
from aho_corasick_1975_tpu_torch import (ByteMachine, DenseScanner, Machine,
                                         MatchSet, StreamSession,
                                         load_machine, save_machine)


def _machine(seed=0, kind="bytes"):
    rng = random.Random(seed)
    m = Machine()
    for i in range(60):
        w = "".join(rng.choice("abc") for _ in range(rng.randint(1, 7)))
        m.insert_keyword(w.encode() if kind == "bytes" else w, value=f"v{i}")
    m.insert_keyword(b"xyzzy" if kind == "bytes" else "xyzzy")
    return m


def _corpus(seed=1, n=6_000, kind="bytes"):
    rng = random.Random(seed)
    text = list("".join(rng.choice("abcx ") for _ in range(n)))
    for edge in (1024, 2048, 4096):       # keywords across chunk edges
        text[edge - 2:edge + 3] = "xyzzy"
    text = "".join(text)
    return text.encode() if kind == "bytes" else text


def _cuts(n, seed=2):
    """Chunk edges: chunks of 1 to 3 symbols (under any halo), then a
    spread of sizes up to 1,500, and every keyword-straddling edge."""
    rng = random.Random(seed)
    cuts = {0, n, 1024, 2048, 4096}
    p = 0
    while p < n:
        p += rng.choice([1, 2, 3, 7, 40, 300, 1500])
        cuts.add(min(p, n))
    return sorted(cuts)


def _chunks(text, cuts):
    return [text[a:b] for a, b in zip(cuts, cuts[1:])]


def _same(a, b):
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.end_states, b.end_states)
    np.testing.assert_array_equal(a.indices, b.indices)


def _pair(m, **kw):
    return JaxScanner(m, **kw), DenseScanner(m, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["bytes", "str"])
@pytest.mark.parametrize("step_k", ["auto", 1, 2, 3])
def test_chunked_sessions_equal_reference(step_k, kind):
    m = _machine(kind=kind)
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    text = _corpus(kind=kind)
    chunks = _chunks(text, _cuts(len(text)))
    assert min(len(c) for c in chunks) < sc.session()._hmax
    js, s = jsc.session(), sc.session()
    for ch in chunks:
        assert s.feed_count(ch) == js.feed_count(ch)
        np.testing.assert_array_equal(s._tail, js._tail)
    assert s.total == js.total == sc.count(text) > 0
    js, s = jsc.session(), sc.session()
    ends = []
    for ch in chunks:
        got = s.feed_matches(ch)
        _same(got, js.feed_matches(ch))
        ends.append(got.ends)
    np.testing.assert_array_equal(np.concatenate(ends),
                                  sc.find_matches(text).ends)
    assert s.total == js.total == len(sc.find_matches(text))
    ck, jck = s.checkpoint(), js.checkpoint()
    assert ck.keys() == jck.keys()
    for key in ck:
        np.testing.assert_array_equal(ck[key], jck[key])


@pytest.mark.parametrize("step_k", [1, 3])
def test_feed_matches_max_hits(step_k):
    m = _machine(3)
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    text = _corpus(4, 3000)
    chunks = _chunks(text, [0, 700, 701, 2000, 3000])
    js, s = jsc.session(), sc.session()
    for ch in chunks:
        bound = len(np.unique(jsc.find_matches(ch).ends)) + 2
        _same(s.feed_matches(ch, max_hits=bound),
              js.feed_matches(ch, max_hits=bound))
    s = sc.session()
    with pytest.raises(ValueError, match="max_hits"):
        s.feed_matches(text, max_hits=1)


def test_empty_chunk():
    m = _machine()
    sc = DenseScanner(m, device="cpu", n_streams=4)
    s = sc.session()
    s.feed_count(b"abcab")
    tail = s._tail.copy()
    assert s.feed_count(b"") == 0
    out = s.feed_matches(b"")
    assert isinstance(out, MatchSet) and len(out) == 0
    assert out.ends.shape == out.starts.shape == (0,)
    np.testing.assert_array_equal(s._tail, tail)
    assert s.offset == 5


def test_tensor_input_to_encode_raises_type_error():
    """C8: a tensor given where signs are expected raises, as the JAX
    package does for a jax.Array, instead of mapping every id to OOV."""
    m = _machine()
    jsc, sc = _pair(m, n_streams=4)
    ids = np.asarray(m.vocab.lookup_many(b"abcab"), np.int32)
    with pytest.raises(TypeError):
        jsc.encode(jnp.asarray(ids))
    with pytest.raises(TypeError):
        sc.encode(torch.from_numpy(ids))
    with pytest.raises(TypeError):
        sc.session().feed_count(torch.from_numpy(ids))
    with pytest.raises(TypeError):
        sc.session().feed_matches(torch.from_numpy(ids))
    # a 1-D id tensor still counts as letter ids
    assert sc.count(torch.from_numpy(ids)) == jsc.count(ids) > 0


def _run_with_crash(make_scanner, crash_at=2):
    """Feed chunks, 'crash' after crash_at of them (every live object
    dropped), restore machine and session from their checkpoints through
    the port's save_machine/load_machine, and finish."""
    m = _machine()
    chunks = _chunks(_corpus(), [0, 1024, 2048, 4096, 6000])
    blob = io.BytesIO()
    save_machine(m, blob)
    sc = make_scanner(m)
    sess = sc.session()
    events = []
    for ch in chunks[:crash_at]:
        events += [(ev.end, mt.text()) for ev, mt in sess.feed_matches(ch)]
    state = sess.checkpoint()
    del sess, sc, m
    blob.seek(0)
    m2 = load_machine(blob)
    assert isinstance(m2, Machine)
    sess2 = StreamSession.restore(make_scanner(m2), state)
    assert sess2.offset == sum(len(c) for c in chunks[:crash_at])
    for ch in chunks[crash_at:]:
        events += [(ev.end, mt.text()) for ev, mt in sess2.feed_matches(ch)]
    return sess2.total, events


@pytest.mark.parametrize("step_k", ["auto", 1])
def test_crash_restore_rescan(step_k):
    make = lambda m: m.scanner(device="cpu", n_streams=8, step_k=step_k)
    total, events = _run_with_crash(make)
    m = _machine()
    sc = make(m)
    text = _corpus()
    want = [(ev.end, mt.text()) for ev, mt in sc.find_matches(text)]
    assert total == sc.count(text) > 0
    assert events == want
    # the JAX package's uninterrupted run agrees
    jsc = JaxScanner(_machine(), n_streams=8, step_k=step_k)
    assert want == [(ev.end, mt.text()) for ev, mt in jsc.find_matches(text)]


def test_crash_restore_counts_only():
    m = _machine()
    text = _corpus()
    chunks = _chunks(text, _cuts(len(text), 5))
    blob = io.BytesIO()
    save_machine(m, blob)
    sess = m.scanner(device="cpu", n_streams=8).session()
    for ch in chunks[:9]:
        sess.feed_count(ch)
    state = sess.checkpoint()
    blob.seek(0)
    m2 = load_machine(blob)
    sess2 = StreamSession.restore(m2.scanner(device="cpu", n_streams=8),
                                  state)
    for ch in chunks[9:]:
        sess2.feed_count(ch)
    assert sess2.total == m.scanner(device="cpu").count(text) > 0


def test_rescan_interrupted_chunk_is_idempotent():
    m = _machine()
    chunks = _chunks(_corpus(), [0, 1024, 2048])
    sc = m.scanner(device="cpu", n_streams=8)
    sess = sc.session()
    sess.feed_count(chunks[0])
    state = sess.checkpoint()
    n1 = sess.feed_count(chunks[1])
    n2 = StreamSession.restore(sc, state).feed_count(chunks[1])
    assert n1 == n2 > 0


def test_restore_refuses_mismatched_snapshot():
    m = _machine()
    sess = m.scanner(device="cpu", n_streams=4).session()
    sess.feed_count(b"abcabc")
    state = sess.checkpoint()
    m.insert_keyword(b"newkw")
    with pytest.raises(ValueError, match="snapshot"):
        StreamSession.restore(m.scanner(device="cpu", n_streams=4), state)
    # the JAX package refuses the port's checkpoint as well
    with pytest.raises(ValueError):
        JaxSession.restore(JaxScanner(m, n_streams=4), state)


def test_byte_machine_session_and_checkpoint():
    rng = random.Random(6)
    m = ByteMachine()
    for _ in range(40):
        m.insert_keyword(bytes(rng.choice(b"ab\x00\xff")
                               for _ in range(rng.randint(1, 5))))
    blob = io.BytesIO()
    save_machine(m, blob)
    blob.seek(0)
    m2 = load_machine(blob)
    assert isinstance(m2, ByteMachine)
    text = bytes(rng.choice(b"ab\x00\xffz") for _ in range(4000))
    jsc = JaxScanner(m, n_streams=4)
    sc = m2.scanner(device="cpu", n_streams=4)
    js, s = jsc.session(), sc.session()
    for ch in _chunks(text, _cuts(len(text), 7)):
        assert s.feed_count(ch) == js.feed_count(ch)
    assert s.total == jsc.count(text) == m.match_stream(
        m.initiate(), text, parallel=False) > 0
