"""K12's geometry on one NVIDIA GPU (an H100): the numbers behind
``ops/scan_assoc.py``'s CHUNK and ``tile_for``.

    python3 probe_assoc_geometry.py

Runs K12 (csrc/assoc_scan.cu) at chunks of 32 to 512 ids and tiles of 32
to 256 chunks over chip_smoke.py's K12 input (2^20 ids, 26 states) and at
a few of them over the slice's dictionary (3,919 states, 2^16 ids), each
exact against K2's one-thread form, and prints each launch's device time
by phase (torch.profiler) and its time a call (CUDA events); then the
host's enqueue time a call of ``assoc_scan`` and of its one
``build.launch``. Imports nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_assoc_geometry: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build, scan_assoc, scan_dense
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.cuda_library()

    def launcher(delta, ids, chunk, tile):
        T, (S, V) = ids.numel(), delta.shape
        B = -(-T // chunk)
        n_tiles = -(-B // tile)
        out = torch.empty(T, dtype=torch.int32, device="cuda")
        fields = dict(table=delta, ext=ids, out=out, L=chunk, B=B, V=V,
                      doc_len=T, n_states=S, tile=tile,
                      compose=torch.empty((B + n_tiles, S), dtype=torch.int32,
                                          device="cuda"),
                      starts=torch.empty(B, dtype=torch.int32, device="cuda"))
        return (lambda: build.launch("ac_assoc_scan", delta.device,
                                     **fields)), out

    def sweep(label, delta, ids, chunks, tiles, reps):
        want = scan_dense.sequential_states(delta.reshape(-1),
                                            delta.shape[1], ids)
        for chunk in chunks:
            for tile in tiles:
                fn, out = launcher(delta, ids, chunk, tile)
                fn()
                torch.cuda.synchronize()
                cs.check(torch.equal(out, want),
                         f"K12 {label} chunk={chunk} tile={tile} is exact")
                ph = cs.kernel_ms(fn, r"assoc_(\w+)_kernel", reps)
                ms = cs.cuda_ms(fn, reps)
                print(f"{label} chunk={chunk} tile={tile}: a call {ms:.4f} "
                      f"ms, device {sum(ph.values()):.4f} ms: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in ph.items()),
                      flush=True)

    rng = np.random.default_rng(1)
    m = act.Machine()
    for _ in range(25):
        m.insert_keyword("".join(rng.choice(list("ab"), rng.integers(1, 6))))
    t = m.compile()
    delta = torch.from_numpy(np.ascontiguousarray(t.delta, np.int32)).cuda()
    ids = torch.from_numpy(np.asarray(m.vocab.lookup_many("".join(
        rng.choice(list("abx"), cs.ASSOC_T))), np.int32)).cuda()
    sweep(f"S={t.n_states} T={cs.ASSOC_T}", delta, ids,
          (32, 64, 128, 256, 512), (32, 64, 128, 256), 20)

    def enqueue_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e3
    print(f"enqueue a call: assoc_scan "
          f"{enqueue_ms(lambda: scan_assoc.assoc_scan(delta, ids)):.4f} ms,"
          f" its build.launch alone "
          f"{enqueue_ms(launcher(delta, ids, 128, 128)[0]):.4f} ms",
          flush=True)

    machine, text, _ = cs.slice_setup(act)
    sc = machine.scanner(n_streams=cs.N_STREAMS)
    d2 = torch.from_numpy(np.ascontiguousarray(sc.tables.delta,
                                               np.int32)).cuda()
    i2 = torch.from_numpy(np.ascontiguousarray(
        sc.encode(text[:cs.ASSOC_SLICE_T]), np.int32)).cuda()
    sweep(f"S={d2.shape[0]} T={cs.ASSOC_SLICE_T}", d2, i2, (32, 64, 128, 256),
          (32, 128), 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
