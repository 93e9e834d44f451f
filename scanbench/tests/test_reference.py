"""The plain reference equals a brute-force comparison at every position
on tiny inputs, whatever the number of streams it splits a text into."""

import random

import numpy as np
import pytest

from scanbench.harness.loops import first_increment
from scanbench.reference import Reference, brute_force


@pytest.mark.parametrize("trial", range(40))
def test_reference_is_brute_force(trial):
    rng = random.Random(trial)
    alpha = rng.choice([b"ab", b"abc", b"a c", b"xyz "])
    kws = [bytes(rng.choice(alpha) for _ in range(rng.randint(1, 6)))
           for _ in range(rng.randint(1, 15))]
    text = bytes(rng.choice(alpha + b"q") for _ in range(rng.randint(0, 400)))
    ref = Reference(kws)
    want = brute_force(kws, text)
    for streams in (1, 2, 5, 64):
        ends, ids = ref.matches(text, streams)
        assert list(zip(ends.tolist(), ids.tolist())) == want
        assert ref.count(text, streams) == len(want)


def test_ids_are_first_insertions():
    ref = Reference([b"he", b"she", b"he", b"hers"])
    assert ref.keywords == [b"he", b"she", b"hers"]
    ends, ids = ref.matches(b"ushers")
    assert ends.tolist() == [3, 3, 5] and ids.tolist() == [1, 0, 2]


def test_count_by_keeps_the_masked_keywords():
    incs = [[b"ab", b"b"], [b"ab", b"ba"]]
    ref = Reference([k for i in incs for k in i])
    inc_of = np.asarray(first_increment(incs))
    assert inc_of.tolist() == [0, 0, 1]
    text = b"abab"
    assert ref.count_by(text, inc_of <= 0) == 4
    assert ref.count_by(text, inc_of <= 1) == 5 == ref.count(text)


def test_empty_keyword_raises():
    with pytest.raises(ValueError):
        Reference([b"a", b""])
