"""The retrieval's device decode (``ops/decode.py:expand_hits_device``)
against the host decode (``expand_hits_arrays``) on CPU tensors; the
stream order it relies on from both refinements; and ``find_matches``
through each refinement against the JAX scanner, multi-output positions
and a refresh between two retrievals included."""

import numpy as np
import pytest
import torch

from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.models import scanner as scanner_mod
from aho_corasick_1975_tpu_torch.ops.decode import (DecodeTables,
                                                    expand_hits_arrays,
                                                    expand_hits_device)

# nested keywords: "hers" ends "he" and "hers", "aaa" ends three
NESTED = [b"he", b"she", b"his", b"hers", b"a", b"aa", b"aaa"]
TEXT = b"To ushers: he found his pencil, but she could not find hers. aaaa "


def _machine(words=NESTED) -> Machine:
    m = Machine()
    m.insert_keywords(list(words))
    return m


def _hits(text: bytes, m: Machine):
    """(positions int64, landing states int32) of every hit position of
    ``text``, from the host decode's own walk."""
    sc = m.scanner(device="cpu", n_streams=1)
    states = sc.scan_states(text)
    (pos,) = np.nonzero(sc.tables.nb_outputs[states])
    return pos.astype(np.int64), states[pos], sc.tables


def _case(name):
    """(positions, states, T, offset, the expected hits) of one case:
    positions -1 padded as the refinements give them."""
    pos, sts, t = _hits(TEXT * 3, _machine())
    pad = lambda p, s, n: (np.concatenate([p, np.full(n, -1, p.dtype)]),
                           np.concatenate([s, np.zeros(n, s.dtype)]))
    if name == "nested":
        return (*pad(pos, sts, 5), len(TEXT) * 3, 0, (pos, sts), t)
    if name == "no_hits":
        return (pos[:0], sts[:0], len(TEXT), 0, (pos[:0], sts[:0]), t)
    if name == "all_padding":
        return (*pad(pos[:0], sts[:0], 16), len(TEXT), 0,
                (pos[:0], sts[:0]), t)
    if name == "past_T":
        # T falls on a hit position: that hit and those after it go
        T = int(pos[len(pos) // 2])
        return (*pad(pos, sts, 3), T, 0, (pos[pos < T], sts[pos < T]), t)
    assert name == "offset"
    return (*pad(pos, sts, 2), len(TEXT) * 3, (1 << 33) + 7, (pos, sts), t)


@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", ["nested", "no_hits", "all_padding",
                                  "past_T", "offset"])
def test_device_decode_is_the_host_decode(name, pos_dtype):
    """int64 positions are the refinements', int32 K8's."""
    positions, states, T, offset, (kpos, ksts), t = _case(name)
    dec = DecodeTables(*(torch.from_numpy(getattr(t, f))
                         for f in DecodeTables._fields))
    got = expand_hits_device(torch.from_numpy(positions).to(pos_dtype),
                             torch.from_numpy(states), T, dec, offset)
    ends, end_states, idx = expand_hits_arrays(kpos, ksts, t, offset)
    for g, w, dtype in zip(got, (ends, end_states, idx,
                                 t.kw_rank[end_states]),
                           (torch.int64, torch.int32, torch.int32,
                            torch.int32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), w)
    if name == "nested":
        # positions that emit two and three events are in the case
        assert set(np.bincount(ends)) >= {1, 2, 3}


@pytest.fixture
def refined(monkeypatch):
    """The positions each refinement hands to the device decode, by
    refinement."""
    seen = []

    def spy(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen.append((fn.__name__, out[0].clone()))
            return out
        return wrapped

    for name in ("hits_extract", "hits_extract_dense"):
        monkeypatch.setattr(scanner_mod, name,
                            spy(getattr(scanner_mod, name)))
    return seen


def _text(T: int, dense: bool, seed: int) -> bytes:
    """Match-dense text (every letter a keyword's) or sparse: spaces with
    a few keywords, so that each refinement runs."""
    rng = np.random.default_rng(seed)
    if dense:
        return rng.choice(np.frombuffer(b"ahers ", np.uint8), T).tobytes()
    out = np.full(T, ord(" "), np.uint8)
    for p in rng.choice(T - 4, 3, replace=False):
        out[p:p + 4] = np.frombuffer(b"aaas", np.uint8)
    return out.tobytes()


@pytest.mark.parametrize("T", [1000, 1237])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_refinements_return_stream_order(B, k, T, refined):
    """Both refinements give positions ascending before their -1 tail, so
    the hits inside the stream are a prefix (T is no multiple of L)."""
    m = _machine()
    sc = DenseScanner(m, device="cpu", n_streams=B, step_k=k)
    assert sc._stepped is not None and sc._stepped.k == k
    for dense in (True, False):
        text = _text(T, dense, seed=B * 10 + k)
        sc.find_matches(text)
    assert [n for n, _ in refined] == ["hits_extract_dense", "hits_extract"]
    for _, pos in refined:
        pos = pos.numpy()
        real = pos >= 0
        n = int(real.sum())
        assert n > 0 and real[:n].all() and not real[n:].any()
        assert (np.diff(pos[:n]) > 0).all()


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dense", [True, False])
def test_find_matches_through_each_refinement_is_jax(dense, k, refined):
    """ends, end_states, indices and ranks equal the JAX scanner's, with
    positions that emit several keywords; the columns are host arrays of
    their own."""
    m = _machine()
    text = _text(3000, dense, seed=5) + b" hers aaa"
    sc = DenseScanner(m, device="cpu", n_streams=4, step_k=k)
    got = sc.find_matches(text, offset=11)
    want = JaxScanner(m, n_streams=4, step_k=k).find_matches(text,
                                                              offset=11)
    assert [n for n, _ in refined] == [
        "hits_extract_dense" if dense else "hits_extract"]
    assert np.bincount(got.ends).max() == 3
    for col in ("ends", "end_states", "indices", "ranks"):
        a = getattr(got, col)
        np.testing.assert_array_equal(a, getattr(want, col))
        assert a.flags.owndata and a.base is None
    assert got._ranks is not None


def test_refresh_between_retrievals_renews_the_decode_tables():
    """The device decode's tables follow the table version: keywords added
    and made live between two retrievals decode with their own ranks."""
    m = _machine([b"he", b"she", b"hers"])
    sc = DenseScanner(m, device="cpu", n_streams=4)
    assert sc._snap.packed is not None
    text = TEXT * 4
    first = sc.find_matches(text)
    v0 = sc._dec_cache[0]
    m.insert_keywords([b"his", b"a", b"aa", b"aaa", b"ers"])
    sc.refresh()
    got = sc.find_matches(text)
    assert sc._dec_cache[0] == sc.tables.version != v0
    want = JaxScanner(m, n_streams=4).find_matches(text)
    assert len(got) > len(first)
    for col in ("ends", "end_states", "indices", "ranks"):
        np.testing.assert_array_equal(getattr(got, col),
                                      getattr(want, col))
