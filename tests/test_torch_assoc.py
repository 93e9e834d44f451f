"""The associative-scan formulation (ops/scan_assoc.py) against the JAX
package's ``make_assoc_scan``, run as tests/test_assoc_scan.py runs it,
and against the port's one-thread ``sequential_states``. Exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.ops.scan_assoc import (
    make_assoc_scan as jax_make_assoc_scan)
from aho_corasick_1975_tpu_torch.ops.scan_assoc import (assoc_scan,
                                                        assoc_scan_plain,
                                                        make_assoc_scan)
from aho_corasick_1975_tpu_torch.ops.scan_dense import sequential_states


def _case(seed, n_text, alpha="abx"):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(25):
        m.insert_keyword("".join(rng.choice("ab")
                                 for _ in range(rng.randint(1, 5))))
    tables = m.compile()
    ids = np.asarray(m.vocab.lookup_many(
        "".join(rng.choice(alpha) for _ in range(n_text))), np.int32)
    return tables, ids


@pytest.mark.parametrize("case", ["seed0", "seed1", "long_random"])
def test_assoc_scan_equals_jax_and_sequential(case):
    if case == "long_random":
        tables, _ = _case(2, 0)
        ids = np.random.default_rng(3).integers(
            0, tables.vocab_size, 5000).astype(np.int32)
    else:
        tables, ids = _case(int(case[-1]), 700)
    V = tables.vocab_size
    want = np.asarray(jax_make_assoc_scan(V)(jnp.asarray(tables.delta),
                                             jnp.asarray(ids)))
    delta = torch.from_numpy(np.ascontiguousarray(tables.delta, np.int32))
    t_ids = torch.from_numpy(ids)
    got = make_assoc_scan(V)(delta, t_ids)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    seq = sequential_states(delta.reshape(-1), V, t_ids)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())


def test_assoc_scan_edges():
    tables, ids = _case(0, 5)
    delta = torch.from_numpy(np.ascontiguousarray(tables.delta, np.int32))
    assert assoc_scan_plain(delta, torch.from_numpy(ids[:1])).numel() == 1
    assert assoc_scan(delta, torch.zeros(0, dtype=torch.int32)).numel() == 0
    with pytest.raises(ValueError, match="delta"):
        make_assoc_scan(tables.vocab_size + 1)(delta, torch.from_numpy(ids))
    with pytest.raises(ValueError, match="ids"):
        assoc_scan(delta, torch.from_numpy(ids.astype(np.int64)))
