"""Rows per warp of K10 and K11 on one NVIDIA GPU (an H100): the times
behind AC_K10_ROWS and AC_K11_ROWS in csrc/ac_scan.cuh.

    python3 probe_mxu_rows.py

The shipped kernels run one rows-per-warp R each (K10 8, K11 1). This
probe rebuilds csrc/mxu_scan.cu with nvcc at R = 1, 2, 4, 8 and 16 for
both kernels, and at R = 1 with AC_MXU_FILL 0 (the vote loop of R > 1,
where the shipped R = 1 lets the one row fill all 16 A rows), one nvcc per
variant, all started together. At chip_smoke.py's shapes (K10: the MXU
dictionary over the slice corpus, B = 16,384 streams, ids form; K11: the
slice's hybrid with text in every column, ids form, and its MMA half alone
as K10's launch over the B2 MMA columns and the hybrid's planes) each
variant's result must equal the shipped kernels', which must equal their
plain versions. Prints each variant's times (CUDA events, mean of 10) with
the products a warp step multiplies (the distinct 32-key tiles among a
warp's rows, walked on the host from the same ids), the card's name and
power limit, and last one JSON line {"rows": [...]}. Exits non-zero on a
mismatch or without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs

VARIANTS = [(R, 1) for R in (1, 2, 4, 8, 16)] + [(1, 0)]   # (R, AC_MXU_FILL)


def build_variants(build) -> dict:
    """mxu_scan.cu at each (R, fill) of VARIANTS, both kernels at R, built
    in parallel: {(R, fill): library}."""
    src = os.path.join(build.CSRC_DIR, "mxu_scan.cu")
    header = os.path.join(build.CSRC_DIR, "ac_scan.cuh")

    def one(R, fill):
        def stages(out, paths):
            return [[[build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                      "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                      f"-DAC_K10_ROWS={R}", f"-DAC_K11_ROWS={R}",
                      f"-DAC_MXU_FILL={fill}", "-I", build.CSRC_DIR, "-o", out,
                      *paths]]]
        lib = ctypes.CDLL(build.build_library(f"mxu_rows{R}_fill{fill}", [src],
                                              stages, [header]))
        for name in ("ac_mxu_count", "ac_hybrid_count"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(build.AcScanArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {v: pool.submit(one, *v) for v in VARIANTS}
        return {v: f.result() for v, f in futs.items()}


class Variant:
    """A rebuilt mxu_scan.cu in the place of the shipped library, for
    build.launch: its two entry points, the shipped error strings."""

    def __init__(self, lib, shipped):
        self.ac_mxu_count = lib.ac_mxu_count
        self.ac_hybrid_count = lib.ac_hybrid_count
        self.ac_error_string = shipped.ac_error_string


def tile_products(delta, ext, B: int, L: int, halo: int, col0: int,
                  R: int) -> float:
    """The products a warp step multiplies, on average over the steps and
    warps of columns [col0, B) at R rows a warp: the distinct 32-key tiles
    among each warp's keys s*V + c, walked through the dense table on the
    host from this run's ids (the stream layout over ext)."""
    V = delta.shape[1]
    cols = np.arange(col0, B)
    pad = np.full(-len(cols) % R, -1)
    s = np.zeros(len(cols), np.int64)
    total = 0
    for t in range(halo + L):
        c = ext[cols * L + t]
        g = np.sort(np.concatenate([(s * V + c) >> 5, pad]).reshape(-1, R),
                    axis=1)
        total += int((g[:, 1:] != g[:, :-1]).sum()) + int((g[:, 0] >= 0).sum())
        s = delta[s, c]
    return total / ((halo + L) * (-(-len(cols) // R)))


def main() -> int:
    if not torch.cuda.is_available():
        cs.log("probe_mxu_rows: no CUDA device; this probe needs the GPU")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build, scan_hybrid, scan_mxu

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    shipped = build.cuda_library()
    libs = build_variants(build)

    B, L = cs.N_STREAMS, cs.KERNEL_L
    machine, text, ranked = cs.slice_setup(act)
    hyb = machine.scanner(n_streams=B, engine="hybrid")
    scm = cs.keyword_machine(act, ranked[:cs.mxu_prefix(act, ranked)]
                             ).scanner(n_streams=B, engine="mxu")
    planes, cbits, n_planes, _ = scm._mxu
    Lm = scm._layout(len(text), 128)[1]
    st = hyb._stepped
    hplanes, cbm, hn, S_pad = hyb._hybrid
    B2 = scan_hybrid.mxu_cols(B, S_pad)
    ids10 = cs.stream_inputs(scm, text, scm.halo, B, Lm)["ids_i32"]
    ids11 = cs.stream_inputs(hyb, text, hyb._halo_sym, B, L,
                             fill=True)["ids_i32"]
    half = (ids11[0][(B - B2) * L:], None, None)
    # name, wrapper, plain, args, ids inputs, dense table, B, L, halo, col0
    kernels = [
        ("K10", functools.partial(scan_mxu.mxu_count, planes_t=scm._planes_t),
         scan_mxu.mxu_count_plain,
         (planes, scm.V, cbits, n_planes, scm.halo, B, Lm), ids10,
         scm.tables.delta, B, Lm, scm.halo, 0),
        ("K11", functools.partial(scan_hybrid.hybrid_count,
                                  planes_t=hyb._planes_t,
                                  warm_steps=hyb._warm_steps),
         scan_hybrid.hybrid_count_plain,
         (hyb._snap.packed, hplanes, st.V, st.k, st.count_bits,
          hyb._halo_steps, hn, cbm, B - B2, B, L), ids11,
         hyb.tables.delta, B, L, hyb._halo_sym, B - B2),
        ("K11's MMA half alone",
         functools.partial(scan_mxu.mxu_count, planes_t=hyb._planes_t),
         scan_mxu.mxu_count_plain,
         (hplanes, st.V, cbm, hn, hyb._halo_sym, B2, L), half,
         hyb.tables.delta, B2, L, hyb._halo_sym, 0)]
    want = []
    for name, fn, plain, args, ins, *_ in kernels:
        got = fn(*args, *ins)
        cs.check(torch.equal(got, plain(*args, *ins)) and int(got.sum()) > 0,
                 f"shipped {name} equals its plain version")
        want.append(got)
    ext = [ins[0].cpu().numpy() for _, _, _, _, ins, *_ in kernels]
    print(f"device: {torch.cuda.get_device_name(0)}; K10 MXU dictionary "
          f"B={B} L={Lm}; K11 slice B={B} (B2={B2} MMA columns) L={L}, "
          f"S_pad={S_pad}", flush=True)
    rows = []
    for (R, fill), lib in libs.items():
        entry = {"R": R, "fill": fill}
        with mock.patch.object(build, "cuda_library",
                               return_value=Variant(lib, shipped)):
            for (name, fn, _, args, ins, delta, Bk, Lk, halo, col0), ref, e \
                    in zip(kernels, want, ext):
                cs.check(torch.equal(fn(*args, *ins), ref),
                         f"{name} at R={R} fill={fill} equals the shipped "
                         "kernel's result")
                ms = cs.cuda_ms(lambda: fn(*args, *ins), 10)
                prods = 1.0 if R == 1 and fill else tile_products(
                    delta, e, Bk, Lk, halo, col0, R)
                entry[name] = {"ms": ms, "products": prods}
        rows.append(entry)
        print(f"R={R} fill={fill}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms, {v['products']:.3f} products a warp "
            "step" for k, v in entry.items() if isinstance(v, dict)),
            flush=True)
    print(smi, flush=True)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
