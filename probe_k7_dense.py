"""K7 dense (the 1-char live-block window count) in its shipped launch,
in the launch choices its design weighed, and in an earlier version of
the kernels, on one NVIDIA GPU (an H100).

    python3 probe_k7_dense.py [--old DIR]

Builds csrc/sparse_scan.cu with nvcc as a library of its own in each of
VARIANTS: the shipped source, and copies with one launch choice patched
(one or two blocks an SM on the SM path instead of as many as fit; the
elided windows on K6's column blocks instead of K1's lanes). With --old,
also the sparse_scan.cu of DIR, a csrc/ directory of an earlier version
of the kernels with this AcScanArgs, e.g.

    mkdir -p build/old
    git archive REV aho_corasick_1975_tpu_torch/csrc | tar -x -C build/old
    python3 probe_k7_dense.py \
        --old build/old/aho_corasick_1975_tpu_torch/csrc

Runs each on chip_smoke.py's K7 dense inputs (the hunt's elided and
index-list windows, the resident 1e-3 windows with words planted), exact
against ``sparse.sparse_count_plain``, through its C entry point
``ac_sparse_count``, and prints its device ms (torch.profiler, mean of 20
calls) at its launcher's pick and at every forced split (the old kernel
takes none), its ms a call (CUDA events, 50 calls) and its entry point's
enqueue ms. Every variant runs twice, in order and then in reverse, so
that a drift of the card shows. Imports nothing of JAX. Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "k7_probe")

# name: (file, text, replacement) patches of the shipped csrc/ copy; each
# text must occur exactly once.
_PAD = ("sparse_scan.cu", "AcDenseStage{0, 0, 0, false}",
        "AcDenseStage{0, 0, 0, true}")
VARIANTS = {
    "shipped": (),
    "one block an SM": (_PAD,),
    "two blocks an SM": (_PAD, (
        "ac_scan.cuh",
        "if (*smem <= d.per_sm / 2) *smem = d.per_sm / 2 + 1;",
        "if (*smem <= d.per_sm / 3) *smem = d.per_sm / 3 + 1;")),
    "column blocks": ((
        "sparse_scan.cu",
        "                   : count_lanes<AcWinLayout>(a, stream, pick);",
        "                   : pick != nullptr\n"
        "                   ? count_lanes<AcWinLayout>(a, stream, pick)\n"
        "                   : (int)ac_launch_cols<AcWinLayout,\n"
        "                         AcDenseTable<int32_t>, 1, false>(\n"
        "                         ac_dense_args(*a),\n"
        "                         (cudaStream_t)stream);"),),
}
# The column blocks run the elided windows only.
ELIDED_ONLY = ("column blocks",)
# Appended to every copy: the P of the process's last split launch (the
# inline variable is one symbol that every library loaded shares).
_LAST_SPLIT = ('\nextern "C" int ac_probe_last_split(void) '
               '{ return g_ac_last_split; }\n')
KERNELS = r"((?:ac_dense_count|ac_cols|sparse_count)_kernel)"


def sources(name: str, csrc: str, patches) -> str:
    """A copy of csrc's ac_scan.cuh and sparse_scan.cu under OUT_DIR/name,
    patched; the path of its sparse_scan.cu."""
    d = os.path.join(OUT_DIR, name.replace(" ", "_"))
    os.makedirs(d, exist_ok=True)
    for f in ("ac_scan.cuh", "sparse_scan.cu"):
        shutil.copy(os.path.join(csrc, f), d)
    for f, old, new in patches + (("sparse_scan.cu", "", _LAST_SPLIT),):
        path = os.path.join(d, f)
        src = open(path).read()
        if old:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {f} holds {old!r} "
                                   f"{src.count(old)} times, not once")
            src = src.replace(old, new)
        else:
            src += new
        open(path, "w").write(src)
    return os.path.join(d, "sparse_scan.cu")


def build_all(nvcc: str, srcs: dict) -> dict:
    """Each {name: sparse_scan.cu} built into a library of its own, one
    nvcc each, all started together; {name: library}."""
    from aho_corasick_1975_tpu_torch.ops import build
    procs = {}
    for name, src in srcs.items():
        so = os.path.splitext(src)[0] + ".so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
             os.path.dirname(src), "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.ac_sparse_count.argtypes = [ctypes.POINTER(build.AcScanArgs),
                                        ctypes.c_void_p]
        lib.ac_sparse_count.restype = ctypes.c_int
        lib.ac_probe_last_split.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(cs, act) -> dict:
    """chip_smoke.py's K7 dense inputs: {kind: (scanner, windows, idx)}."""
    m = act.Machine()
    for kw in cs.SPARSE_KEYWORDS:
        m.insert_keyword(kw)
    text = cs.hunt_corpus()
    sc = m.scanner(n_streams=4096, prefilter="on")
    sc.count(text)
    ent = sc._get_lut("byte")
    raw = np.frombuffer(text, np.uint8)
    hunt_t = torch.from_numpy(ent[3][raw]).to("cuda")
    mr = act.Machine()
    for w in cs.RESIDENT_WORDS:
        mr.insert_keyword(w)
    scb1 = mr.scanner(n_streams=4096, prefilter="on", step_k=1)
    planted = cs.planted_resident(mr, cs.resident_ids(
        1e-3, len(set("".join(cs.RESIDENT_WORDS)))))
    planted_t = torch.from_numpy(planted).to("cuda")
    scb1.count(planted_t)
    tm, _ = cs.elided_windows(sc, raw, (ent[3], ent[1]), sc.halo, 128)
    tm1, _ = cs.elided_windows(scb1, planted, None, scb1.halo, 128)
    return {"elided (a)": (sc, tm, None),
            "idx (a) tensor": (sc, *cs.device_windows(sc, hunt_t, sc.halo,
                                                      128)),
            "elided (b) 1e-3 planted": (scb1, tm1, None),
            "idx (b) 1e-3 planted": (scb1, *cs.device_windows(
                scb1, planted_t, scb1.halo, 128))}


def run(cs, lib, name: str, kind: str, s, src, idx, splits) -> None:
    """One variant on one input: exact at each split, then its times."""
    from aho_corasick_1975_tpu_torch.ops import build, scan_dense, sparse
    args = (s._snap.dflat, s._snap.nb_out, s.V, s.halo, 128, src, idx)
    want = sparse.sparse_count_plain(*args)
    total = int(want.long().sum())
    cs.check(total > 0, f"{kind}: the windows hold matches")
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    row = []
    for P in splits:
        fields = dict(table=s._snap.dflat, nb_out=s._snap.nb_out, out=out,
                      L=128, V=s.V, halo=s.halo,
                      **sparse.window_fields(128, src, idx),
                      **scan_dense.dense_fields(
                          s._snap.dflat, s.V, s._warm_syms, P,
                          s.tables.n_states, False))
        fields.pop("form")
        c_args = build.scan_args(**fields)

        def fn():
            cs.check(lib.ac_sparse_count(ctypes.byref(c_args), stream) == 0,
                     f"{name} ({kind}) launches")
        out.zero_()
        fn()
        torch.cuda.synchronize()
        cs.check(torch.equal(out, want),
                 f"{name} ({kind}) at split {P or 'pick'} is exact")
        dev = sum(cs.kernel_ms(fn, KERNELS).values())
        taken = ("one thread a window" if name == "old"
                 else f"P={lib.ac_probe_last_split()}")
        if P == 0:
            row.append(f"pick ({taken}) {dev:.4f}, a call "
                       f"{cs.cuda_ms(fn, 50):.4f}, enqueue "
                       f"{cs.enqueue_ms(fn):.4f}")
        else:
            row.append(f"P={P} {dev:.4f}")
    print(f"{name} | {kind}: plain total {total}; device ms (exact at "
          f"each): {'; '.join(row)}", flush=True)


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="csrc/ directory of an earlier version")
    opts = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("probe_k7_dense: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    srcs = {name: sources(name, build.CSRC_DIR, patches)
            for name, patches in VARIANTS.items()}
    if opts.old:
        srcs["old"] = sources("old", opts.old, ())
    libs = build_all(build._nvcc(), srcs)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ins = inputs(cs, act)
    order = (["old"] if opts.old else []) + list(VARIANTS)
    for name in order + order[::-1]:
        for kind, (s, src, idx) in ins.items():
            if name in ELIDED_ONLY and idx is not None:
                continue
            splits = (0,) if name == "old" else (0,) + cs.SPLIT_SWEEP
            run(cs, libs[name], name, kind, s, src, idx, splits)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
