"""The port's own host layer against the JAX package's.

The port keeps its own copies of the JAX package's jax-free host modules
(builders, vocabulary, machines, checkpoints, match decoding, the acm_*
functional API). For the same keywords, on both builder backends, the
copies must give the JAX package's dense tables and host matches, the
reference's golden line, and checkpoints that load in either package to
the same automaton; the port exports the same public names. The native core builds into the port's build
directory, not beside its source.
"""

import io
import os
import random

import numpy as np
import pytest

import aho_corasick_1975_tpu as ac
import aho_corasick_1975_tpu_torch as act
from aho_corasick_1975_tpu_torch.core import native
from aho_corasick_1975_tpu_torch.ops import build

WORDS = ["he", "she", "his", "hers"]
TEXT = "To ushers: he found his pencil, but she could not find hers."
GOLDEN = " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"
FIELDS = ("delta", "nb_outputs", "fail", "depth", "is_end", "kw_rank",
          "prev_state", "prev_letter", "emit_start", "emit_state")
BACKENDS = ("python", "native")


def _keywords(seed=0, n=300):
    rng = random.Random(seed)
    return ["".join(rng.choice("abcdefg") for _ in range(rng.randint(1, 7)))
            for _ in range(n)]


def _pair(backend, words, incremental=True):
    jm = ac.Machine(backend=backend, incremental=incremental)
    pm = act.Machine(backend=backend, incremental=incremental)
    for w in words:
        jm.insert_keyword(w)
        pm.insert_keyword(w)
    return jm, pm


def _same_tables(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.version, a.n_keywords, a.vocab_size) == \
        (b.version, b.n_keywords, b.vocab_size)


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_compile_equals_reference(backend, incremental):
    jm, pm = _pair(backend, _keywords(), incremental)
    assert type(pm._b).__module__.startswith("aho_corasick_1975_tpu_torch.")
    _same_tables(jm.compile(), pm.compile())


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_stream_equals_reference(backend):
    jm, pm = _pair(backend, _keywords(1))
    text = "".join(random.Random(2).choice("abcdefgx ") for _ in range(5000))
    want = jm.match_stream(jm.initiate(), text)
    assert want > 0
    assert pm.match_stream(pm.initiate(), text) == want
    cj, cp = jm.initiate(), pm.initiate()
    for ch in text[:500]:
        n = jm.match(cj, ch)
        assert pm.match(cp, ch) == n
        for j in range(n):
            assert pm.get_match(cp, j).text() == jm.get_match(cj, j).text()


def test_golden_line_through_the_acm_api():
    machine = act.acm_create()
    state = act.acm_initiate(machine)
    for w in WORDS:
        for ch in w:
            act.acm_insert_letter_of_keyword(state, ch)
        act.acm_insert_end_of_keyword(state)
    matcher = act.acm_matcher_init()
    cst = act.acm_initiate(machine)
    out = []
    for i, ch in enumerate(TEXT):
        for j in range(act.acm_match(cst, ch), 0, -1):
            act.acm_get_match(cst, j - 1, matcher)
            out.append(f" {i + 2 - matcher[0].length}:{matcher[0].text()}")
    assert "".join(out) == GOLDEN
    assert act.acm_nb_keywords(machine) == 4
    act.acm_matcher_release(matcher)
    act.acm_release(machine)


def test_public_api_equals_reference():
    """The port exports the JAX package's names, ``__version__`` included,
    at the same version."""
    assert set(act.__all__) == set(ac.__all__)
    assert all(hasattr(act, name) for name in act.__all__)
    assert act.__version__ == ac.__version__


def _roundtrip(save, load, machine):
    blob = io.BytesIO()
    save(machine, blob)
    blob.seek(0)
    return load(blob)


@pytest.mark.parametrize("kind", ["str", "bytes"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoints_load_across_packages(backend, kind):
    """A machine saved by one package loads in the other to the same
    tables, of the loading package's own classes, and stays mutable."""
    words = _keywords(3, 120)
    if kind == "bytes":
        jm, pm = ac.ByteMachine(backend=backend), act.ByteMachine(
            backend=backend)
        words = [w.encode() for w in words]
    else:
        jm, pm = _pair(backend, [])
    for w in words:
        jm.insert_keyword(w, value=len(w))
        pm.insert_keyword(w, value=len(w))
    into_port = _roundtrip(ac.save_machine, act.load_machine, jm)
    into_jax = _roundtrip(act.save_machine, ac.load_machine, pm)
    assert type(into_port) is type(pm) and type(into_jax) is type(jm)
    for m in (into_port, into_jax):
        _same_tables(jm.compile(), m.compile())
    assert into_port.vocab.key_fn is pm.vocab.key_fn
    extra = b"gfedcba" if kind == "bytes" else "gfedcba"
    for m in (into_port, into_jax, jm):
        m.insert_keyword(extra)
    _same_tables(jm.compile(), into_port.compile())
    _same_tables(jm.compile(), into_jax.compile())
    tabs = _roundtrip(act.save_tables, ac.load_tables, pm.compile())
    _same_tables(pm.compile(), tabs)


def test_native_core_builds_under_the_port_build_dir():
    native.load_library()
    path = os.path.realpath(native.library_path)
    assert os.path.dirname(path) == os.path.realpath(build.BUILD_DIR)
    assert os.path.basename(path).startswith("libacx_")
    assert "torch_kernels" in path.split(os.sep)
