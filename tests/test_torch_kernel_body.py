"""The CUDA kernels' per-stream code, run on the CPU.

csrc/ac_scan.cuh holds everything one CUDA thread of K1-K4 computes. The
host shim csrc/ac_scan_host.cpp compiles it with g++ behind the kernels'
own C entry points, so the logic the H100 runs is checked here against the
plain PyTorch versions, with exact equality: k in {1, 2, 3}, a halo longer
than a stream, raw uint8 and int32 inputs with non-zero head_ids.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import torch_cases as tc
from aho_corasick_1975_tpu_torch.ops import build, hits, multistep, scan_dense

B = tc.B
SHAPES = {"halo": (5, 24), "long_halo": (9, 4)}


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build.host_library()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _run(lib, name, **fields):
    args = build.scan_args(**fields)
    assert getattr(lib, name)(ctypes.byref(args), None) == 0


def _common(s, halo, L, V):
    ext = _t(s["ext"])
    return dict(ext=ext, lut=_t(s["lut"]), head_ids=_t(s["head_ids"]), L=L,
                B=B, V=V, halo=halo, ext_u8=int(ext.dtype == torch.uint8),
                n_lut=0 if s["lut"] is None else len(s["lut"]))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
def test_dense_kernels(lib, kind, shape):
    tab = tc.tables(1)
    halo, L = SHAPES[shape]
    s = tc.stream(tab, kind, halo, L)
    V, dflat, nb_out = tab["V"], _t(tab["dflat"]), _t(tab["nb_out"])
    plain_args = (V, halo, B, L, _t(s["ext"]), _t(s["lut"]),
                  _t(s["head_ids"]))
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_count", table=dflat, nb_out=nb_out, out=out,
         **_common(s, halo, L, V))
    want = scan_dense.dense_count_plain(dflat, nb_out, *plain_args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    states = torch.full((B * L,), -7, dtype=torch.int32)
    _run(lib, "ac_dense_states", table=dflat, out=states,
         **_common(s, halo, L, V))
    assert torch.equal(states, scan_dense.dense_states_plain(dflat,
                                                             *plain_args))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", tc.KINDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_stepped_kernels(lib, k, kind, shape):
    tab = tc.tables(k)
    halo_steps = -(-SHAPES[shape][0] // k)
    L = 8 * k if shape == "halo" else 2 * k
    s = tc.stream(tab, kind, halo_steps * k, L)
    V, cb, packed = tab["V"], tab["count_bits"], _t(tab["packed"])
    common = dict(_common(s, halo_steps * k, L, V), Vk=V ** k, k=k,
                  count_bits=cb)
    plain_args = (packed, V, k, cb, halo_steps, B, L, _t(s["ext"]),
                  _t(s["lut"]), _t(s["head_ids"]))
    out = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_count", table=packed, out=out, **common)
    want = multistep.stepped_count_plain(*plain_args)
    assert torch.equal(out, want) and int(want.sum()) > 0
    emit = torch.full((B, L // k), -7, dtype=torch.int32)
    n_hits = torch.full((B,), -7, dtype=torch.int32)
    n_live = torch.full((B,), -7, dtype=torch.int32)
    _run(lib, "ac_stepped_emit", table=packed, out=emit, n_hits=n_hits,
         n_live=n_live, **common)
    for got, want in zip((emit, n_hits, n_live),
                         hits.stepped_emit_plain(*plain_args)):
        assert torch.equal(got, want)
