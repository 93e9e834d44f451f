"""The port's count_many (device="cpu", where K5 and K6 take their plain
versions) against the JAX package's and the per-document host oracle.

The cases of tests/test_count_many.py that need no mesh: per-document
counts equal the reference's run of each document alone, no state leaks
between documents, padding adds nothing, raw byte and UTF-8 batches stage
raw, mixed kinds encode on the host, a resident [L, B] tensor equals the
JAX package's jax.Array (misaligned L included), documents split into
halo-warmed blocks stay exact, and out-of-range resident ids raise.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu_torch import ByteMachine, DenseScanner, Machine


def build_machine(seed=0, n_kw=40, alphabet="abcd"):
    rng = random.Random(seed)
    m = Machine()
    for _ in range(n_kw):
        m.insert_keyword("".join(rng.choice(alphabet)
                                 for _ in range(rng.randint(1, 5))))
    return m, rng


def oracle_counts(m, docs):
    out = []
    for d in docs:
        cur = m.initiate()
        out.append(sum(m.match(cur, ch) for ch in d))
    return np.asarray(out, np.int64)


def _pair(m, **kw):
    return JaxScanner(m, **kw), DenseScanner(m, device="cpu", **kw)


def _check(sc, jsc, m, docs):
    got = sc.count_many(docs)
    assert got.dtype == np.int64 and got.shape == (len(docs),)
    np.testing.assert_array_equal(got, jsc.count_many(docs))
    np.testing.assert_array_equal(got, oracle_counts(m, docs))
    return got


@pytest.mark.parametrize("step_k", ["auto", 1, 2, 3])
def test_count_many_equals_reference_and_oracle(step_k):
    m, rng = build_machine()
    docs = ["".join(rng.choice("abcdz") for _ in range(rng.randint(0, 700)))
            for _ in range(23)]
    docs[3] = ""                      # empty document
    docs[7] = "zzzzz"                 # OOV-only document
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    assert _check(sc, jsc, m, docs).sum() > 0
    assert sc.stats["last_op"] == "count_many_raw"


def test_no_state_leak_between_documents():
    m = Machine()
    m.insert_keyword("abab")
    sc = DenseScanner(m, device="cpu", n_streams=4)
    np.testing.assert_array_equal(sc.count_many(["xxab", "abxx"]), [0, 0])


@pytest.mark.parametrize("step_k", [1, 3])
def test_padding_emits_nothing(step_k):
    m, _ = build_machine(seed=1)
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    L = 128 * sc.step_k
    _check(sc, jsc, m, ["ab" * (L // 2), "a", "abcd" * 3])


def test_empty_batch_and_singleton():
    m, _ = build_machine(seed=2)
    jsc, sc = _pair(m, n_streams=4)
    assert sc.count_many([]).shape == (0,)
    assert sc.count_many([]).dtype == np.int64
    _check(sc, jsc, m, ["abcd"])


def test_matches_single_stream_count():
    m, rng = build_machine(seed=3)
    docs = ["".join(rng.choice("abcd ") for _ in range(rng.randint(1, 300)))
            for _ in range(9)]
    sc = DenseScanner(m, device="cpu", n_streams=4)
    assert int(sc.count_many(docs).sum()) == sum(sc.count(d) for d in docs)


@pytest.mark.parametrize("step_k", ["auto", 1])
def test_raw_byte_batch(step_k):
    rng = random.Random(5)
    m = ByteMachine()
    for _ in range(30):
        m.insert_keyword(bytes(rng.choice(b"abcd")
                               for _ in range(rng.randint(1, 5))))
    docs = [bytes(rng.choice(b"abcdz\x00") for _ in range(rng.randint(0, 900)))
            for _ in range(17)]
    docs[2] = b""
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    got = _check(sc, jsc, m, docs)
    assert sc.stats["last_op"] == "count_many_raw"
    # the id path (host encode, int32 batch) gives the same counts
    ids_sc = DenseScanner(m, device="cpu", n_streams=4, step_k=step_k,
                          device_encode=False)
    np.testing.assert_array_equal(ids_sc.count_many(docs), got)
    assert ids_sc.stats["last_op"] == "count_many"


def test_raw_utf8_str_batch_on_byte_machine():
    m = ByteMachine()
    m.insert_keyword("héllo")
    m.insert_keyword("wörld")
    docs = ["say héllo", "wörld wörld!", "", "plain ascii", "héllowörld"]
    jsc, sc = _pair(m, n_streams=4)
    got = sc.count_many(docs)
    np.testing.assert_array_equal(got, [1, 2, 0, 0, 2])
    np.testing.assert_array_equal(got, jsc.count_many(docs))
    assert sc.stats["last_op"] == "count_many_raw"


def test_mixed_kind_batch_falls_back_to_host_encode():
    m, _ = build_machine(seed=6)
    jsc, sc = _pair(m, n_streams=4)
    docs = ["abcd", b"abcd"]
    got = sc.count_many(docs)
    assert sc.stats["last_op"] == "count_many"
    np.testing.assert_array_equal(got, jsc.count_many(docs))
    np.testing.assert_array_equal(got, [sc.count(d) for d in docs])
    sc.count_many(["abcd", "dcba"])
    assert sc.stats["last_op"] == "count_many_raw"
    m2 = Machine()
    m2.insert_keyword((1, 2))
    sc2 = DenseScanner(m2, device="cpu", n_streams=4)
    got = sc2.count_many([(1, 2, 1, 2), (9, 9), ()])
    np.testing.assert_array_equal(got, [2, 0, 0])
    assert sc2.stats["last_op"] == "count_many"


@pytest.mark.parametrize("step_k", ["auto", 1, 2, 3])
def test_device_resident_batch(step_k):
    m, rng = build_machine(seed=7)
    docs = ["".join(rng.choice("abcdz") for _ in range(rng.randint(1, 300)))
            for _ in range(11)]
    jsc, sc = _pair(m, n_streams=4, step_k=step_k)
    want = oracle_counts(m, docs)
    for L in (768, 769):              # 769: not a multiple of k, K6 takes it
        tm = np.zeros((L, len(docs)), np.int32)
        for j, d in enumerate(docs):
            ids = sc.encode(d)
            tm[:len(ids), j] = ids
        got = sc.count_many(torch.from_numpy(tm))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jsc.count_many(jnp.asarray(tm)))
        assert sc.stats["last_op"] == "count_many_device"
        # any integer dtype; a non-contiguous view
        np.testing.assert_array_equal(
            sc.count_many(torch.from_numpy(tm.astype(np.int64))), want)
        wide = torch.from_numpy(np.repeat(tm, 2, axis=1))[:, ::2]
        np.testing.assert_array_equal(sc.count_many(wide), want)


def test_device_resident_batch_is_validated():
    m, _ = build_machine(seed=8)
    sc = DenseScanner(m, device="cpu", n_streams=4)
    with pytest.raises(ValueError, match="integer"):
        sc.count_many(torch.zeros((8, 8), dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\[L, B\]"):
        sc.count_many(torch.zeros(8, dtype=torch.int32))
    # ids outside [0, V): the reference clamps, the port raises (C3)
    for bad in (sc.V, -1):
        tm = torch.zeros((16, 4), dtype=torch.int32)
        tm[3, 2] = bad
        with pytest.raises(ValueError, match="outside"):
            sc.count_many(tm)
    assert sc.count_many(torch.zeros((16, 0), dtype=torch.int32)).shape == (0,)
    np.testing.assert_array_equal(
        sc.count_many(torch.zeros((0, 3), dtype=torch.int32)), [0, 0, 0])


@pytest.mark.parametrize("step_k", [1, 2, 3])
def test_document_splitting_parity(step_k):
    m, rng = build_machine(seed=11, alphabet="ab")
    docs = ["".join(rng.choice("abz") for _ in range(9000 + i * 1000))
            for i in range(3)]
    jsc, sc = _pair(m, n_streams=512, step_k=step_k)
    unit = 128 * step_k
    c, Lp = sc._split_for(16 * unit, 8, unit)
    assert c > 1 and (c, Lp) == jsc._split_for(16 * unit, 8, unit)
    _check(sc, jsc, m, docs)


def test_split_straddles_block_edges():
    m = Machine()
    m.insert_keyword("abcabc")
    jsc, sc = _pair(m, n_streams=1024, step_k=1)
    doc = ["z"] * 6000
    ends = 0
    for p in range(125, 6000 - 6, 128):
        doc[p:p + 6] = "abcabc"
        ends += 1
    docs = ["".join(doc), "abcabc", ""]
    got = sc.count_many(docs)
    np.testing.assert_array_equal(got, [ends, 1, 0])
    np.testing.assert_array_equal(got, jsc.count_many(docs))


def test_tensor_documents_raise_like_the_reference():
    """A list of tensors is a list of documents of signs: encoding one
    raises TypeError (C8), as a list of jax.Arrays does in the reference."""
    m, _ = build_machine(seed=12)
    jsc, sc = _pair(m, n_streams=4)
    ids = np.asarray(m.vocab.lookup_many("abcd"), np.int32)
    with pytest.raises(TypeError):
        jsc.count_many([jnp.asarray(ids)])
    with pytest.raises(TypeError):
        sc.count_many([torch.from_numpy(ids)])
