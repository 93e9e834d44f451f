"""Each configuration's inputs come from the seed alone: the same seed
gives the same keywords and texts, another seed others."""

import pytest
import torch

from scanbench.harness import spec
from scanbench.tests.small import CONFIG

BENCH = spec.load_benchmark()


def make(name, seed):
    cell = next(spec.find_cell(BENCH, w["name"]) for w in BENCH["workloads"]
                if w["config"] == name)
    cfg = dict(cell.config, **CONFIG.get(name, {}))
    return cell.generator().make(cfg, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_inputs(name, seed):
    a, b, c = make(name, seed), make(name, seed), make(name, seed + 1)
    assert a.increments == b.increments
    assert a.texts(2, 3000, 7) == b.texts(2, 3000, 7)
    assert a.texts(1, 3000, 7) != a.texts(1, 3000, 8)
    assert a.texts(2, 3000, 7) != c.texts(2, 3000, 7)
    assert all(len(t) == 3000 for t in a.texts(3, 3000, 1))


def test_words1000_shape():
    d = make("words1000", 3)
    kws = d.increments[0]
    assert len(kws) == 1000 == len(set(kws))
    assert all(k[:1] == b" " and k[-1:] == b" " and b" " not in k[1:-1]
               for k in kws)
    assert len(set(d.words)) == 6966
    text = d.texts(1, 1 << 16)[0]
    toks = text.split(b" ")[:-1]
    assert 4.5 < sum(map(len, toks)) / len(toks) < 4.95
    assert set(text) <= set(b" abcdefghijklmnopqrstuvwxyz")


def test_random7x250k_shape():
    cell = spec.find_cell(BENCH, "random7x250k.increments")
    cfg = cell.config
    assert (cfg["increments"], cfg["keywords_per_increment"],
            cfg["keyword_letters"]) == (10, 25000, 7)
    d = cell.generator().make(dict(cfg, keywords_per_increment=500), 9,
                              torch.device("cpu"))
    assert [len(i) for i in d.increments] == [500] * 10
    assert all(len(k) == 7 and set(k) <= set(b"abcdefghijklmnopqrstuvwxyz")
               for i in d.increments for k in i)
