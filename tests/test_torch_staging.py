"""The staging ring (models/staging.py) and the port's staged uploads, on
the CPU, against the JAX package.

A scanner on ``device="cpu"`` stages through plain CPU tensors in the same
ring order as on the card, with no stream and no events, so these tests
exercise the ring's reuse and the zeroed pad: the pipelined count with a
short last chunk landing in a slot that held keyword bytes, the ring's own
counters, the refusal of a CUDA stager to stage pageable memory, inputs
larger than a slot, the other staged paths (sessions, count_many, the
prefilter), and threads sharing one scanner's ring. The pipeline's
thresholds are monkeypatched small on both
packages' scanners, as tests/test_torch_scanner.py does. Inputs are made
from seeds; counts and MatchSets must be equal.
"""

import random
import sys
import threading

import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu.models.scanner import \
    StreamSession as JaxSession
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.models.staging import Stager

C = 2048            # the pipeline's chunk, in symbols
N_CHUNKS = 6
LAST = 1031         # the last chunk's symbols: prime, not a multiple of 128
KEYWORD = "abca"


def _words(seed=5):
    rng = random.Random(seed)
    return [KEYWORD] + ["".join(rng.choice("abc")
                                for _ in range(rng.randint(1, 6)))
                        for _ in range(40)]


def _machines(kind="bytes"):
    """(JAX machine, port machine) of the same keywords, as bytes or as
    str."""
    jm, pm = ac.Machine(), Machine()
    for w in _words():
        key = w.encode() if kind == "bytes" else w
        jm.insert_keyword(key)
        pm.insert_keyword(key)
    return jm, pm


def _pipelined_text(seed=1) -> bytes:
    """N_CHUNKS chunks of C bytes, the last LAST bytes; a keyword across
    every chunk edge; the two chunks before the last (as many as the
    ring's slots) all keyword bytes, so the slot the short last chunk
    lands in holds keywords past its end."""
    rng = np.random.default_rng(seed)
    n = (N_CHUNKS - 1) * C + LAST
    text = bytearray(rng.choice(np.frombuffer(b"abcx ", np.uint8),
                                n).tobytes())
    for i in (N_CHUNKS - 3, N_CHUNKS - 2):
        text[i * C:(i + 1) * C] = KEYWORD.encode() * (C // len(KEYWORD))
    for i in range(1, N_CHUNKS):
        text[i * C - 2:i * C + 2] = KEYWORD.encode()
    return bytes(text)


@pytest.fixture
def small_ring(monkeypatch):
    for cls in (DenseScanner, JaxScanner):
        monkeypatch.setattr(cls, "_pipeline_min", 3 * C)
        monkeypatch.setattr(cls, "_pipeline_chunk", C)
    monkeypatch.setattr(DenseScanner, "_pipeline_depth", 2)


def _oracle(m, text, head=None):
    if head is None:
        return m.match_stream(m.initiate(), text, parallel=False)
    return (m.match_stream(m.initiate(), head + text, parallel=False)
            - m.match_stream(m.initiate(), head, parallel=False))


# -- (a) the pipelined count ----------------------------------------------

@pytest.mark.parametrize("kind", ["bytes", "str"])
@pytest.mark.parametrize("engine,step_k", [
    ("gather", 3), ("gather", 1), ("hybrid", 3), ("mxu", "auto")])
def test_pipelined_count_through_the_ring(small_ring, kind, engine, step_k):
    """Six chunks through a ring of two slots: equal to the JAX scanner's
    single launch (``_count_raw``), to its own pipelined count where that
    runs (not at step_k=1, ROADMAP C.7), and to the native host scan, with
    and without a head."""
    jm, pm = _machines(kind)
    kw = dict(n_streams=16, step_k=step_k, engine=engine)
    jsc, sc = JaxScanner(jm, **kw), DenseScanner(pm, device="cpu", **kw)
    data = _pipelined_text()
    signs = data if kind == "bytes" else data.decode()
    head_signs = b"ab" if kind == "bytes" else "ab"
    head = np.asarray(pm.vocab.lookup_many(head_signs), np.int32)
    for h, hs in ((None, None), (head, head_signs)):
        used = sc._stager.slots_used if sc._ring is not None else 0
        got = sc.count(signs, head=h)
        assert sc._stager.slots_used - used == N_CHUNKS
        assert got == jsc._count_raw(*jsc._raw_stream(signs), h)
        assert got == _oracle(pm, signs, hs) > 0
        if step_k != 1:
            assert got == jsc.count(signs, head=h)


def test_short_last_chunk_needs_the_zeroed_pad(small_ring):
    """The last chunk's slot held keyword bytes past its end before it was
    staged: counting them would add matches."""
    jm, pm = _machines()
    sc = DenseScanner(pm, device="cpu", n_streams=16, step_k=3)
    data = _pipelined_text()
    whole = _oracle(pm, data)
    assert sc.count(data) == whole
    last = data[(N_CHUNKS - 1) * C:]
    stale = data[(N_CHUNKS - 3) * C:(N_CHUNKS - 2) * C]
    assert _oracle(pm, last + stale[len(last):]) > _oracle(pm, last)


# -- (b) the ring ------------------------------------------------------------

def test_ring_order_and_zeroed_pad():
    st = Stager("cpu", 2, 64)
    head = np.array([1, 2, 3], np.int32)
    long, short = np.full(40, 7, np.uint8), np.full(5, 9, np.uint8)
    slots = []
    for body in (long, long, short):
        slot = st.stage(head, body, 48)
        slots.append(slot)
        if body is short:
            # the reused device buffer still holds the long chunk's bytes
            assert slot.dev[16 + 3 + 5:16 + 3 + 40].tolist() == [7] * 35
        ext, h = st.ready(slot)
        assert h.tolist() == head.tolist()
        assert ext.tolist() == [0] * 3 + body.tolist() + [0] * (45 - len(
            body))
        st.release(slot)
    assert [s.index for s in slots] == [0, 1, 0]
    assert slots[2].dev is slots[0].dev
    assert st.slots_used == 3 and st.pad_zeroed == 5 + 5 + 40


def test_ring_grows_for_a_larger_chunk_and_keeps_its_order():
    st = Stager("cpu", 3, 32)
    body = np.arange(100, dtype=np.int32)
    slot = st.stage(np.zeros(2, np.int32), body, 130)
    ext, head = st.ready(slot)
    assert st.slot_bytes >= 16 + 130 * 4 and slot.index == 0
    assert ext.dtype == torch.int32 and ext.numel() == 130
    assert ext.tolist() == [0, 0] + body.tolist() + [0] * 28
    assert head.tolist() == [0, 0]
    st.release(slot)
    assert st.stage(np.zeros(0, np.int32), body[:3], 3).index == 1


@pytest.mark.parametrize("shape,dtype", [((1000,), np.int32),
                                         ((37, 5), np.uint8),
                                         ((0,), np.int32)])
def test_upload_goes_through_the_ring_in_slot_pieces(shape, dtype):
    st = Stager("cpu", 2, 64)
    a = np.random.default_rng(0).integers(0, 200, shape).astype(dtype)
    out = st.upload(a)
    assert out.shape == a.shape and out.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(out.numpy(), a)
    assert st.slots_used == -(-a.nbytes // 64)
    ext = st.padded(np.arange(5, dtype=np.int32), 2, 9,
                    np.array([8, 9], np.int32))
    assert ext.tolist() == [8, 9, 0, 1, 2, 3, 4, 0, 0, 0, 0]
    with pytest.raises(ValueError):
        st.upload_into(torch.empty(3, dtype=torch.int32), a.reshape(-1)[:4])


def test_download_goes_through_the_ring_in_slot_pieces():
    """Tensors of several dtypes, larger and smaller than a slot, and
    empty, come back as host arrays that own their memory, one slot a
    piece."""
    st = Stager("cpu", 2, 64)
    ts = [torch.arange(100, dtype=torch.int64) - 50,
          torch.arange(7, dtype=torch.int32).reshape(7, 1),
          torch.zeros(0, dtype=torch.int32),
          torch.arange(300, dtype=torch.int16).to(torch.uint8)]
    got = st.download(*ts)
    for g, t in zip(got, ts):
        assert g.flags.owndata and g.base is None and g.shape == t.shape
        assert torch.from_numpy(g).dtype == t.dtype
        np.testing.assert_array_equal(g, t.numpy())
    assert st.slots_used == sum(-(-t.nbytes // 64) for t in ts)
    with pytest.raises(ValueError):
        st.download(torch.arange(8)[::2])


# -- (c) no fallback -------------------------------------------------------

def test_cuda_stager_never_stages_pageable_memory(monkeypatch):
    """On a torch without CUDA a stager for the card raises. With its
    stream and events stubbed, pinning the slots fails and raises: the
    stager never falls back to pageable memory."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        Stager("cuda", 2, 64)

    class Stream:
        def __init__(self, device=None):
            self.device = torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: object())
    with pytest.raises(RuntimeError, match="pin"):
        Stager("cuda", 2, 64)
    with pytest.raises(ValueError):
        Stager("cpu", 1, 64)


# -- (d) inputs larger than a slot -------------------------------------------

@pytest.mark.parametrize("step_k", [3, 1])
def test_retrieval_of_inputs_larger_than_a_slot(monkeypatch, step_k):
    """find_matches() (K4, or K2's states decoded at step_k=1, and K8
    under max_hits) and scan_states() of inputs of many slots equal the
    JAX scanner's, element for element."""
    monkeypatch.setattr(DenseScanner, "_pipeline_chunk", 256)
    jm, pm = _machines()
    kw = dict(n_streams=8, step_k=step_k)
    jsc, sc = JaxScanner(jm, **kw), DenseScanner(pm, device="cpu", **kw)
    data = _pipelined_text(3)[:10_000]
    ids = jsc.encode(data)
    head = ids[:4]
    for signs in (data, ids):
        for h in (None, head):
            used = sc._stager.slots_used if sc._ring is not None else 0
            got, want = (sc.find_matches(signs, head=h),
                         jsc.find_matches(signs, head=h))
            assert sc._stager.slots_used - used >= len(data) // 256
            np.testing.assert_array_equal(got.ends, want.ends)
            np.testing.assert_array_equal(got.end_states, want.end_states)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(sc.scan_states(signs, head=h),
                                          jsc.scan_states(signs, head=h))
    bounded = sc.find_matches(data, max_hits=len(got) + 8)
    np.testing.assert_array_equal(bounded.ends,
                                  jsc.find_matches(data).ends)
    np.testing.assert_array_equal(sc.scan_states_sequential(data),
                                  jsc.scan_states_sequential(data))


# -- (e) the other staged paths ----------------------------------------------

def test_session_over_uneven_chunks_through_the_ring(small_ring):
    """Chunks of 1 symbol to several pipeline chunks (pipelined inside the
    session) give the JAX session's counts, chunk by chunk."""
    jm, pm = _machines()
    kw = dict(n_streams=16)
    js, s = (JaxSession(JaxScanner(jm, **kw)),
             DenseScanner(pm, device="cpu", **kw).session())
    data = _pipelined_text(4) + _pipelined_text(5)
    rng = random.Random(6)
    p = 0
    while p < len(data):
        n = rng.choice([1, 3, 100, 700, 4 * C, 3 * C + 5])
        chunk = data[p:p + n]
        assert s.feed_count(chunk) == js.feed_count(chunk)
        p += n
    assert s.total == js.total == _oracle(pm, data)


def test_count_many_and_prefilter_through_small_slots(monkeypatch):
    monkeypatch.setattr(DenseScanner, "_pipeline_chunk", 200)
    jm, pm = _machines()
    kw = dict(n_streams=8)
    jsc, sc = JaxScanner(jm, **kw), DenseScanner(pm, device="cpu", **kw)
    data = _pipelined_text(7)
    docs = [data[i * 997:i * 997 + n] for i, n in
            enumerate([0, 5, 300, 1200, 4000, 64])]
    np.testing.assert_array_equal(sc.count_many(docs), jsc.count_many(docs))
    sparse = bytes(3000) + data[:600] + bytes(9000) + data[:50]
    kw["prefilter"] = "on"
    jsp, sp = JaxScanner(jm, **kw), DenseScanner(pm, device="cpu", **kw)
    ids = jsp.encode(sparse)
    for signs in (sparse, ids):
        assert sp.count(signs) == jsp.count(signs) > 0
        got, want = sp.find_matches(signs), jsp.find_matches(signs)
        np.testing.assert_array_equal(got.ends, want.ends)
        np.testing.assert_array_equal(got.indices, want.indices)
    assert sp._stager.slots_used > 0


def test_threads_share_one_ring(small_ring):
    """More threads than cores count and retrieve through one scanner's
    ring, with a short switch interval: the dispatch lock keeps every
    result exact and the ring's counters whole."""
    jm, pm = _machines()
    sc = DenseScanner(pm, device="cpu", n_streams=16, step_k=3)
    data = _pipelined_text(8)
    want = _oracle(pm, data)
    small = data[:3000]
    want_small = _oracle(pm, small)
    results, errors = [], []

    def work(i):
        try:
            if i % 2:
                results.append(("count", sc.count(data)))
            else:
                results.append(("find", len(sc.find_matches(small))))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(results) == sorted([("count", want)] * 5
                                     + [("find", want_small)] * 5)
    assert sc._stager.slots_used >= 5 * N_CHUNKS
