"""The port's sparse prefilter (``prefilter="on"|"auto"``) against the JAX
scanner, on the CPU where K7 and K8 take their plain versions.

Counts are equal, MatchSets equal element for element (ends, end_states,
indices), and so are ``stats["sparse_live_frac"]`` and
``stats["sparse_elided_upload_bytes"]``. Inputs: bytes and uint8 arrays
(the raw filter and elision), str, host int32 ids (the host filter, taking
the elided or the indexed path) and a letter-id tensor against a
``jax.Array`` (the device block filter). The cases of the JAX package's
single-device tests/test_sparse.py, test_sparse_device.py and
test_sparse_hits.py run here as parametrised cases, plus the auto
full-decode fallback without a packed table, the exact size of K8's
outputs and ``scan_states_sequential``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu_torch import DenseScanner
from aho_corasick_1975_tpu_torch.models import scanner as port_scanner
from aho_corasick_1975_tpu_torch.ops import sparse

KEYWORDS = ["needle", "haystack", "nee", "ack", "stacks", "ey", "needles"]
HIT_WORDS = ["needle", "pin", "hay", "nee", "inha"]


def _machine(words=KEYWORDS, as_bytes=True):
    m = ac.Machine()
    for w in words:
        m.insert_keyword(w.encode() if as_bytes else w)
    return m


def _pair(m, **kw):
    return JaxScanner(m, **kw), DenseScanner(m, device="cpu", **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.end_states, b.end_states)
    np.testing.assert_array_equal(a.indices, b.indices)


def _same_stats(sc, jsc):
    for key in ("sparse_live_frac", "sparse_elided_upload_bytes"):
        assert sc.stats.get(key) == jsc.stats.get(key), key


def _brute_count(text, keywords):
    return sum(sum(1 for i in range(len(text) - len(k) + 1)
                   if text[i:i + len(k)] == k) for k in keywords)


def _sparse_text(rng, n, keywords, density=0.01, filler="0123456789+-*/"):
    """Mostly-OOV text with keyword letters and whole keywords sprinkled
    (tests/test_sparse.py)."""
    chars = [rng.choice(filler) for _ in range(n)]
    i = 0
    while i < n - 10:
        if rng.random() < density:
            kw = rng.choice(keywords)
            if rng.random() < 0.5:
                chars[i:i + len(kw)] = list(kw)
                i += len(kw)
            else:
                chars[i] = rng.choice(kw)
                i += 1
        i += rng.randint(1, 200)
    return "".join(chars)


def _blocks(L_blk, live_frac, seed, n_blocks=100):
    """n_blocks blocks of L_blk bytes of 0x00 (OOV); the first
    live_frac*n_blocks of a seeded permutation hold a keyword, some of
    them straddling the next block's edge."""
    rng = np.random.default_rng(seed)
    body = bytearray(n_blocks * L_blk)
    for b in rng.permutation(n_blocks)[:int(live_frac * n_blocks)]:
        kw = KEYWORDS[int(b) % len(KEYWORDS)].encode()
        p = int(b) * L_blk + (L_blk - 3 if b % 3 == 0 else int(b) % 40)
        p = min(p, len(body) - len(kw))
        body[p:p + len(kw)] = kw
    return bytes(body)


# -- the matrix: k, prefilter mode, density, every input kind ----------------


@pytest.mark.parametrize("corpus", ["sparse", "half", "dense"])
@pytest.mark.parametrize("prefilter", ["on", "auto"])
@pytest.mark.parametrize("step_k", [1, 2, "auto"])
def test_prefilter_matches_jax(step_k, prefilter, corpus):
    """"sparse" elides, "half" (49 of 100 blocks live, so the live windows
    pass half the stream) takes the indexed path on host ids, "dense"
    makes "auto" decline."""
    m = _machine()
    jsc, sc = _pair(m, n_streams=8, prefilter=prefilter, step_k=step_k)
    assert sc.step_k == jsc.step_k
    L_blk = sc._sparse_geometry()[2]
    data = _blocks(L_blk, {"sparse": 0.05, "half": 0.49, "dense": 1.0}[corpus],
                   seed=len(corpus))
    ids = np.asarray(m.vocab.lookup_many(data), np.int32)
    head = np.asarray(m.vocab.lookup_many(b"need"), np.int32)
    for signs in (data, np.frombuffer(data, np.uint8), ids):
        for h in (None, head):
            assert sc.count(signs, head=h) == jsc.count(signs, head=h) > 0
            _same_stats(sc, jsc)
            want = jsc.find_matches(signs, head=h)
            _same(sc.find_matches(signs, head=h), want)
            _same_stats(sc, jsc)
            n_pos = len(np.unique(want.ends))
            _same(sc.find_matches(signs, offset=5, head=h, max_hits=n_pos),
                  jsc.find_matches(signs, offset=5, head=h, max_hits=n_pos))
    t_ids, j_ids = torch.from_numpy(ids), jnp.asarray(ids)
    for h in (None, head):
        assert sc.count(t_ids, head=h) == jsc.count(j_ids, head=h) > 0
        _same_stats(sc, jsc)
        _same(sc.find_matches(t_ids, head=h), jsc.find_matches(j_ids, head=h))
        _same(sc.find_matches(t_ids, head=h, max_hits=1 << 12),
              jsc.find_matches(j_ids, head=h, max_hits=1 << 12))


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_sparse_count_matches_dense_and_oracle(mode):
    rng = random.Random(11)
    m = _machine(as_bytes=False)
    jsc, sc = _pair(m, n_streams=8, prefilter=mode)
    dense = DenseScanner(m, device="cpu", n_streams=8)
    for n in (100, 5000, 60000):
        text = _sparse_text(rng, n, KEYWORDS)
        want = _brute_count(text, KEYWORDS)
        assert sc.count(text) == dense.count(text) == jsc.count(text) == want
        _same_stats(sc, jsc)
        _same(sc.find_matches(text), jsc.find_matches(text))
    assert "sparse_live_frac" in sc.stats


@pytest.mark.parametrize("step_k", ["auto", 1])
def test_sparse_elision_exact_and_engaged(step_k):
    """Keywords across block edges; the elided windows upload under half
    the corpus; a session carries a keyword across its chunk edge."""
    m = _machine(as_bytes=False)
    jsc, sc = _pair(m, n_streams=8, prefilter="on", step_k=step_k)
    text = list("x" * 50_000)
    for pos in (127, 3000, 8191, 30_000):
        text[pos:pos + 6] = "needle"
    text = "".join(text)
    want = _brute_count(text, KEYWORDS)
    assert sc.count(text) == jsc.count(text) == want
    _same_stats(sc, jsc)
    assert sc.stats["sparse_elided_upload_bytes"] < len(text) * 4 // 2
    for jsess, sess in ((jsc.session(), sc.session()),):
        got = sess.feed_count(text[:8193]) + sess.feed_count(text[8193:])
        assert got == jsess.feed_count(text[:8193]) + jsess.feed_count(
            text[8193:]) == want


def test_sparse_raw_elision_bytes_str_and_session():
    m = _machine()
    jsc, sc = _pair(m, n_streams=8, prefilter="on")
    body = bytearray(b"\x00" * 60_000)
    for pos in (500, 8190, 40_000):
        body[pos:pos + 6] = b"needle"
    data = bytes(body)
    want = m.match_stream(m.initiate(), data)
    assert sc.count(data) == jsc.count(data) == want > 0
    _same_stats(sc, jsc)
    sess = sc.session()
    assert sess.feed_count(data[:8193]) + sess.feed_count(data[8193:]) == want
    m2 = _machine(["héé"], as_bytes=False)
    jsc2, sc2 = _pair(m2, n_streams=8, prefilter="on")
    text = " " * 30_000 + "héé" + " " * 5000
    assert sc2._raw_stream(text) is not None
    assert sc2.count(text) == jsc2.count(text) == 1
    _same_stats(sc2, jsc2)
    _same(sc2.find_matches(text), jsc2.find_matches(text))


def test_sparse_auto_dense_raw_skips_refilter(monkeypatch):
    """"auto" on a match-dense raw corpus: the raw filter's "dense"
    verdict goes straight to the dense raw kernels; the id-path filter
    does not run again."""
    m = _machine()
    sc = DenseScanner(m, device="cpu", n_streams=8, prefilter="auto")
    data = b"needle" * 3000

    def boom(*a, **kw):
        raise AssertionError("the id-path filter re-ran")
    monkeypatch.setattr(sparse, "live_blocks", boom)
    assert sc.count(data) == m.match_stream(m.initiate(), data) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sparse_raw_elision_differential_fuzz(seed):
    """Seeded densities, both modes and ragged session feeds against the
    host oracle and the JAX scanner."""
    rng = random.Random(100 + seed)
    m = ac.Machine()
    kws = [kw.encode() for kw in KEYWORDS] + [b"\x00z\x00"]  # a NUL letter
    for kw in kws[:5 + seed]:
        m.insert_keyword(kw)
    density = [0.0005, 0.005, 0.05, 0.4][seed]
    n = 40_000 + 7000 * seed
    body = bytearray(b"\x01" * n)          # 0x01 appears in no keyword
    for _ in range(max(1, int(n * density / 8))):
        kw = kws[rng.randrange(len(kws[:5 + seed]))]
        p = rng.randrange(0, n - 16)
        body[p:p + len(kw)] = kw
    data = bytes(body)
    want = m.match_stream(m.initiate(), data)
    for mode in ("on", "auto"):
        jsc, sc = _pair(m, n_streams=8, prefilter=mode)
        assert sc.count(data) == jsc.count(data) == want, (seed, mode)
        _same_stats(sc, jsc)
        _same(sc.find_matches(data), jsc.find_matches(data))
        sess, total, pos = sc.session(), 0, 0
        while pos < n:
            step = rng.choice([13, 257, 5000])
            total += sess.feed_count(data[pos:pos + step])
            pos += step
        assert total == want, (seed, mode)


def test_sparse_dense_corpus_exact_and_auto_fallback():
    rng = random.Random(5)
    m = _machine(["ab", "bc", "abc", "ca"], as_bytes=False)
    text = "".join(rng.choice("abc") for _ in range(30000))
    want = DenseScanner(m, device="cpu", n_streams=8).count(text)
    for mode in ("on", "auto"):
        jsc, sc = _pair(m, n_streams=8, prefilter=mode)
        assert sc.count(text) == jsc.count(text) == want
        _same_stats(sc, jsc)
        if mode == "on":
            assert sc.stats["sparse_live_frac"] == 1.0
        _same(sc.find_matches(text), jsc.find_matches(text))


@pytest.mark.parametrize("kind", ["str", "tensor"])
def test_sparse_all_oov_short_circuits(kind):
    m = _machine(["xyz"], as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    text = "0123456789" * 500
    signs = text if kind == "str" else torch.from_numpy(sc.encode(text))
    assert sc.count(signs) == 0
    assert sc.stats["sparse_live_frac"] == 0.0
    assert len(sc.find_matches(signs)) == 0
    assert hasattr(sc.find_matches(signs, max_hits=8), "ends")
    assert jsc.count(text) == 0


@pytest.mark.parametrize("edge", [128, 256, 131072])
def test_sparse_match_spanning_block_edge(edge):
    m = _machine(["needle"], as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    text = list("." * (edge + 64))
    text[edge - 3:edge + 3] = "needle"
    text = "".join(text)
    assert sc.count(text) == jsc.count(text) == 1
    _same(sc.find_matches(text), jsc.find_matches(text))


def test_sparse_stepped_core_larger_machine():
    rng = random.Random(23)
    m = ac.Machine()
    m.insert_keywords(["".join(rng.choice("nedl") for _ in range(6))
                       for _ in range(300)] + ["needle"])
    jsc, sc = _pair(m, prefilter="on")
    assert sc._stepped is not None
    text = _sparse_text(rng, 50000, ["needle", "nedd", "ledde"])
    want = DenseScanner(m, device="cpu").count(text)
    assert sc.count(text) == jsc.count(text) == want
    _same_stats(sc, jsc)


@pytest.mark.parametrize("kind", ["str", "bytes"])
def test_sparse_session_two_chunks(kind):
    """Counts and matches of a two-chunk session equal the JAX session's
    and the whole stream's."""
    m = _machine(as_bytes=kind == "bytes")
    jsc, sc = _pair(m, prefilter="on")
    text = list("." * 4000)
    text[1998:2004] = "needle"             # spans the chunk edge at 2000
    text[3100:3108] = "haystack"
    text = "".join(text)
    if kind == "bytes":
        text = text.encode()
    parts = (text[:2000], text[2000:])
    s, js = sc.session(), jsc.session()
    assert [s.feed_count(p) for p in parts] == [js.feed_count(p)
                                               for p in parts]
    assert s.total == sc.count(text) == 4      # needle, nee, haystack, ack
    s, js = sc.session(), jsc.session()
    for p in parts:
        _same(s.feed_matches(p), js.feed_matches(p))
    s = sc.session()
    ends = np.concatenate([s.feed_matches(p, max_hits=8).ends for p in parts])
    np.testing.assert_array_equal(ends, sc.find_matches(text).ends)


def test_sparse_rejects_bad_mode():
    m = _machine(["a"], as_bytes=False)
    with pytest.raises(ValueError, match="prefilter"):
        DenseScanner(m, device="cpu", prefilter="yes")


# -- device-resident corpora: the block filter on the device -----------------


def _dev_machine(seed=0, n=40, alpha="abcde"):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(n):
        m.insert_keyword("".join(rng.choice(alpha)
                                 for _ in range(rng.randint(2, 6))))
    return m


def _islands(seed, islands=9, dead_len=1200, live_len=83):
    rng = random.Random(seed)
    dead = "".join(rng.choice("XYZQ ") for _ in range(dead_len))
    out = []
    for _ in range(islands):
        out.append(dead)
        out.append("".join(rng.choice("abcde") for _ in range(live_len)))
    return "".join(out)


@pytest.mark.parametrize("step_k", [2, 1])
def test_device_filter_count_parity(step_k):
    m = _dev_machine(seed=2 + step_k)
    jsc, sc = _pair(m, n_streams=16, prefilter="on", step_k=step_k)
    text = _islands(3)
    ids = sc.encode(text)
    want = DenseScanner(m, device="cpu", n_streams=16).count(text)
    assert sc.count(torch.from_numpy(ids)) == jsc.count(jnp.asarray(ids)) \
        == want
    _same_stats(sc, jsc)
    assert sc.stats["sparse_live_frac"] < 0.5
    assert sc.count(text) == want
    h = ids[:max(sc.halo, sc._halo_sym)]
    assert sc.count(torch.from_numpy(ids), head=h) == jsc.count(
        jnp.asarray(ids), head=h)


def test_device_filter_all_oov_and_auto_decline():
    m = _dev_machine(seed=8)
    sc = DenseScanner(m, device="cpu", n_streams=8, prefilter="on")
    assert sc.count(torch.from_numpy(sc.encode("XYZ " * 3000))) == 0
    jauto, auto = _pair(m, n_streams=8, prefilter="auto")
    rng = random.Random(9)
    live = "".join(rng.choice("abcde") for _ in range(4000))
    ids = auto.encode(live)
    assert auto.count(torch.from_numpy(ids)) == jauto.count(
        jnp.asarray(ids)) == DenseScanner(m, device="cpu").count(live)
    _same_stats(auto, jauto)


def test_device_resident_find_matches_parity_and_bound():
    m = _dev_machine(seed=20)
    jsc, sc = _pair(m, n_streams=8, prefilter="on")
    text = _islands(21)
    ids = sc.encode(text)
    got = sc.find_matches(torch.from_numpy(ids))
    assert sc.stats["last_op"] == "find_matches_sparse"
    _same(got, jsc.find_matches(jnp.asarray(ids)))
    _same(got, DenseScanner(m, device="cpu", n_streams=8).find_matches(text))
    _same(sc.find_matches(torch.from_numpy(ids), max_hits=1 << 14), got)
    assert len(got) > 4
    for s in (sc, jsc):
        with pytest.raises(ValueError, match="max_hits"):
            s.find_matches(ids if s is jsc else torch.from_numpy(ids),
                           max_hits=2)


def test_device_resident_find_matches_empty_and_auto_gate():
    m = _dev_machine(seed=22)
    sc = DenseScanner(m, device="cpu", n_streams=8, prefilter="on")
    out = sc.find_matches(torch.from_numpy(sc.encode("XYZ " * 2000)))
    assert len(out) == 0 and hasattr(out, "ends")
    jauto, auto = _pair(m, n_streams=8, prefilter="auto")
    rng = random.Random(23)
    live = "".join(rng.choice("abcde") for _ in range(4000))
    ids = auto.encode(live)
    _same(auto.find_matches(torch.from_numpy(ids)),
          jauto.find_matches(jnp.asarray(ids)))
    assert auto.stats["last_op"] == "find_matches_device"


# -- retrieval (tests/test_sparse_hits.py) -----------------------------------


def _hits_corpus(rng, n=1500, p=0.08):
    parts = []
    for _ in range(n):
        parts.append("z" * rng.randint(40, 180))
        if rng.random() < p:
            parts.append(rng.choice(["needle", "pin", "hay", "haypin",
                                     "pinhay", "nee"]))
    return "".join(parts)


@pytest.mark.parametrize("max_hits", [None, 8192])
def test_sparse_hits_match_dense_decode(max_hits):
    m = _machine(HIT_WORDS, as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    text = _hits_corpus(random.Random(0))
    got = sc.find_matches(text, max_hits=max_hits)
    assert sc.stats["last_op"] == "find_matches_sparse"
    _same(got, DenseScanner(m, device="cpu").find_matches(text))
    _same(got, jsc.find_matches(text, max_hits=max_hits))
    for (ev, mt), (ev2, mt2) in zip(list(got)[:50],
                                    list(jsc.find_matches(text))[:50]):
        assert (ev.start, ev.end, mt.text()) == (ev2.start, ev2.end,
                                                 mt2.text())


@pytest.mark.parametrize("case", ["head", "straddle", "offset", "all_oov"])
def test_sparse_hits_cases(case):
    m = _machine(HIT_WORDS, as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    head = None
    if case == "head":
        head, text = m.vocab.lookup_many("need"), "le" + "z" * 700 + "pin"
    elif case == "straddle":
        text = ("z" * 125 + "needle") * 40
    elif case == "offset":
        text = "z" * 300 + "pin" + "z" * 300
    else:
        text = "z" * 5000
    for bound in (None, 1024):
        got = sc.find_matches(text, offset=1000, head=head, max_hits=bound)
        _same(got, jsc.find_matches(text, offset=1000, head=head,
                                    max_hits=bound))
    if case == "offset":
        assert list(got.ends) == [1000 + 300 + 2]
    assert (len(got) == 0) == (case == "all_oov")


def test_elided_hits_engaged_and_exact():
    m = _machine(HIT_WORDS, as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    text = "z" * 40_000 + "needle" + "z" * 20_000 + "pinhay" + "z" * 5000
    got = sc.find_matches(text, max_hits=256)
    _same(got, DenseScanner(m, device="cpu").find_matches(text))
    _same(got, jsc.find_matches(text, max_hits=256))
    _same_stats(sc, jsc)
    assert sc.stats["sparse_elided_upload_bytes"] < len(text) * 4 // 4
    mb = _machine(["needle", "pin"])
    jspb, spb = _pair(mb, prefilter="on")
    data = b"\x00" * 30_000 + b"needle" + b"\x00" * 9000 + b"pin"
    ref = DenseScanner(mb, device="cpu").find_matches(data)
    _same(spb.find_matches(data, max_hits=64), ref)
    sess = spb.session()
    e = [(ev.end, mt.text()) for ev, mt in
         sess.feed_matches(data[:30_003], max_hits=64)]
    e += [(ev.end, mt.text()) for ev, mt in
          sess.feed_matches(data[30_003:], max_hits=64)]
    assert e == [(ev.end, mt.text()) for ev, mt in ref]
    for s in (spb, jspb):
        with pytest.raises(ValueError, match="max_hits"):
            s.find_matches(data, max_hits=1)


@pytest.mark.parametrize("kind", ["str", "bytes", "ids"])
def test_sparse_hits_overflow_raises(kind):
    """The max_hits raise through the indexed, elided and id paths."""
    m = _machine(HIT_WORDS, as_bytes=kind == "bytes")
    jsc, sc = _pair(m, prefilter="on")
    text = _hits_corpus(random.Random(1))
    signs = {"str": text, "bytes": text.encode(),
             "ids": np.asarray(m.vocab.lookup_many(
                 text.encode() if kind == "bytes" else text), np.int32)}[kind]
    for s in (sc, jsc):
        with pytest.raises(ValueError, match="max_hits"):
            s.find_matches(signs, max_hits=2)


def test_sparse_hits_auto_falls_back_when_dense():
    m = _machine(HIT_WORDS, as_bytes=False)
    jsc, sc = _pair(m, prefilter="auto")
    text = "needlepinhay" * 500
    got = sc.find_matches(text, max_hits=1 << 14)
    assert sc.stats["last_op"] == "find_matches_device"
    _same(got, jsc.find_matches(text, max_hits=1 << 14))
    _same(got, DenseScanner(m, device="cpu").find_matches(text))


@pytest.mark.parametrize("why", ["auto_dense", "halo_over_block"])
def test_declined_prefilter_without_packed_table_decodes(why):
    """The prefilter declines on a scanner with no packed table and no
    max_hits: the full decode answers (``models/scanner.py:1359-1364``),
    where a comparison with a missing bound would raise TypeError; with
    max_hits, K8's stream form."""
    m = _machine(HIT_WORDS, as_bytes=False)
    if why == "auto_dense":
        kw, text = dict(prefilter="auto", step_k=1), "needlepinhay" * 500
    else:
        kw, text = dict(prefilter="on", step_k=1, halo=200), \
            "z" * 3000 + "needle" + "z" * 900
    jsc, sc = _pair(m, **kw)
    assert sc._stepped is None
    want = jsc.find_matches(text)
    _same(sc.find_matches(text), want)
    assert sc.stats["last_op"] == "scan_states"
    _same(sc.find_matches(text, max_hits=len(want)), want)
    assert sc.stats["last_op"] == "find_matches_device"


def test_k8_outputs_hold_exactly_the_hits(monkeypatch):
    """ROADMAP C4: the reference sizes its prefilter's auto hit buffers
    to pow2(n_live * L_blk); K8's outputs hold exactly n_hit_pos entries,
    8 bytes each, and the MatchSet is the reference's."""
    seen = []
    real = port_scanner.window_hits

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((out[0].numel(), out[1].numel(), out[3]))
        return out
    monkeypatch.setattr(port_scanner, "window_hits", spy)
    m = _machine(HIT_WORDS, as_bytes=False)
    jsc, sc = _pair(m, prefilter="on")
    for text in (_hits_corpus(random.Random(4)),
                 "z" * 40_000 + "needle" + "z" * 20_000 + "pinhay"):
        got = sc.find_matches(text)
        _same(got, jsc.find_matches(text))
        n_pos = len(np.unique(got.ends))
        L_blk, n_live = 128, int(sparse.live_blocks(sc.encode(text),
                                                    128).sum())
        assert seen[-1] == (n_pos, n_pos, n_pos)
        assert n_pos * 8 < max(8, 1 << (n_live * L_blk - 1).bit_length())


def test_scan_states_sequential_matches_jax():
    m = _machine()
    jsc, sc = _pair(m, prefilter="on")
    data = _blocks(128, 0.3, seed=5)[:5000]
    np.testing.assert_array_equal(sc.scan_states_sequential(data),
                                  jsc.scan_states_sequential(data))
    np.testing.assert_array_equal(sc.scan_states_sequential(data),
                                  sc.scan_states(data))
    assert sc.scan_states_sequential(b"").shape == (0,)
