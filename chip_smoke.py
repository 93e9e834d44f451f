"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path (aho_corasick_1975_tpu_torch) end to end on
the card, importing nothing of JAX:

1. build: compiles the CUDA kernels of csrc/ with nvcc (sm_90a);
2. golden: the he/she/his/hers example, count and find_matches;
3. kernels: K1-K4 each against its plain PyTorch version on the same
   inputs, at the slice's shapes (B = 16,384 streams of bench.py's
   dictionary and corpus), exact equality (tolerance 0), with times;
4. slice: bench.py's 1,000-keyword byte dictionary over its 64 MiB seeded
   corpus, through Machine.scanner(): count() against the native host
   scan, find_matches() (length equal to the count, a seeded sample of
   1,000 matches checked against the text), and a step_k=1 scanner (K1
   and K2) giving the same count and match ends. Launch counters show
   that this phase ran every kernel.

Prints the kernels' JSON line, the card's name and power limit, and last
the line {"ok": true, "device": {...}}. Any failure exits non-zero, and
so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_KEYWORDS = 1000
TARGET_BYTES = 64 * 1024 * 1024
N_STREAMS = 16384
KERNEL_L = 4224     # find_matches' per-stream length at 64 MiB
GOLDEN = "To ushers: he found his pencil, but she could not find hers."
GOLDEN_LINE = " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"
KERNELS = {   # entry point -> (name, source, TPU-side function it replaces)
    "ac_dense_count": (
        "K1 dense_count", "aho_corasick_1975_tpu_torch/csrc/dense_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_pallas.py:51"),
    "ac_dense_states": (
        "K2 dense_states", "aho_corasick_1975_tpu_torch/csrc/dense_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_xla.py:197"),
    "ac_stepped_count": (
        "K3 stepped_count",
        "aho_corasick_1975_tpu_torch/csrc/stepped_scan.cu",
        "aho_corasick_1975_tpu/ops/multistep.py:247"),
    "ac_stepped_emit": (
        "K4 stepped_emit",
        "aho_corasick_1975_tpu_torch/csrc/stepped_scan.cu",
        "aho_corasick_1975_tpu/ops/hits.py:132"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def corpus() -> str:
    """bench.py's seeded synthetic corpus (its fallback when the reference
    corpus is absent), normalised as bench.py does."""
    rng = np.random.default_rng(0)
    words = ["".join(rng.choice(list("abcdefghij"), size=rng.integers(2, 9)))
             for _ in range(2000)]
    raw = " ".join(rng.choice(words) for _ in range(60000))
    return re.sub(r"[^a-z]", " ", raw.lower())


def slice_setup(act):
    norm = corpus()
    freq: dict = {}
    for w in norm.split():
        freq[w] = freq.get(w, 0) + 1
    words = sorted(freq, key=lambda w: (-freq[w], w))[:N_KEYWORDS]
    machine = act.Machine()
    for w in words:
        machine.insert_keyword(b" " + w.encode() + b" ")
    reps = max(1, TARGET_BYTES // len(norm))
    return machine, ((norm + " ") * reps).encode()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one
    warm-up run (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, "kernel output shape")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_kernels(sc, text: bytes) -> dict:
    """K1-K4 against their plain versions at the slice's shapes, on the
    slice's tables and corpus: raw uint8 and int32 letter-id inputs,
    non-zero head_ids."""
    from aho_corasick_1975_tpu_torch.ops import hits, multistep, scan_dense
    st, snap = sc._stepped, sc._snap
    check(st is not None and st.k == 3, "the slice's packed table has k=3")
    rng = np.random.default_rng(1)
    lut_host = sc._get_lut("byte")[3]
    lut = snap.place(lut_host)
    B, L = N_STREAMS, KERNEL_L
    results = {}

    def inputs(halo):
        raw = np.zeros(halo + B * L, np.uint8)
        n = min(len(text), B * L)
        raw[halo:halo + n] = np.frombuffer(text, np.uint8)[:n]
        head = rng.integers(1, sc.V, halo).astype(np.int32)
        ids = lut_host[raw].astype(np.int32)
        ids[:halo] = head
        return {"raw_u8": (snap.place(raw), lut, snap.place(head)),
                "ids_i32": (snap.place(ids), None, None)}

    dense_in = inputs(sc.halo)
    step_in = inputs(sc._halo_sym)
    cases = {
        "ac_dense_count": (scan_dense.dense_count, scan_dense.dense_count_plain,
                           (snap.dflat, snap.nb_out, sc.V, sc.halo, B, L),
                           dense_in),
        "ac_dense_states": (scan_dense.dense_states,
                            scan_dense.dense_states_plain,
                            (snap.dflat, sc.V, sc.halo, B, L), dense_in),
        "ac_stepped_count": (multistep.stepped_count,
                             multistep.stepped_count_plain,
                             (snap.packed, st.V, st.k, st.count_bits,
                              sc._halo_steps, B, L), step_in),
        "ac_stepped_emit": (hits.stepped_emit, hits.stepped_emit_plain,
                            (snap.packed, st.V, st.k, st.count_bits,
                             sc._halo_steps, B, L), step_in),
    }
    for name, (kernel, plain, args, ins) in cases.items():
        res = {}
        for kind, (ext, lut_t, head) in ins.items():
            got = kernel(*args, ext, lut_t, head)
            torch.cuda.synchronize()
            want = plain(*args, ext, lut_t, head)
            err = max_abs_err(got, want)
            check(err == 0, f"{name} ({kind}) equals its plain version")
            ms = cuda_ms(lambda: kernel(*args, ext, lut_t, head), 10)
            plain_ms = cuda_ms(lambda: plain(*args, ext, lut_t, head), 2)
            res[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            print(f"kernel {name} {kind} B={B} L={L}: {ms:.4f} ms, plain "
                  f"{plain_ms:.2f} ms, max_abs_err {err}", flush=True)
        results[name] = res
    return results


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false); this smoke run needs the GPU")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build.cuda_library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.last_build['seconds']})", flush=True)
    log(str(build.last_build["log"])[-3000:])

    # 2. golden
    m = act.Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    for step_k in ("auto", 1):
        sc = m.scanner(step_k=step_k)
        check(sc.count(GOLDEN) == 9, f"golden count (step_k={step_k})")
        ev = sorted(sc.find_matches(GOLDEN),
                    key=lambda e: (e[0].end, -e[0].index))
        line = "".join(f" {e.start + 1}:{mt.text()}" for e, mt in ev)
        check(line == GOLDEN_LINE, f"golden matches (step_k={step_k}): "
              f"{line!r}")
    print("golden: ok", flush=True)

    # 3. kernels against their plain versions, at the slice's shapes
    t0 = time.perf_counter()
    machine, text = slice_setup(act)
    sc = machine.scanner(n_streams=N_STREAMS)
    sc1 = machine.scanner(n_streams=N_STREAMS, step_k=1)
    tabs = sc.tables
    print(f"slice: {len(text)} bytes, {tabs.n_states} states, V={sc.V}, "
          f"step_k={sc.step_k}, count_bits={sc._stepped.count_bits}, "
          f"halo={sc.halo}, halo_steps={sc._halo_steps}, packed "
          f"{sc._snap.packed.numel() * 4} bytes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kern = phase_kernels(sc, text)

    # 4. the slice through the user's entry points
    build.reset_launches()
    t0 = time.perf_counter()
    n = sc.count(text)
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms = sc.find_matches(text)
    find_s = time.perf_counter() - t0
    n1 = sc1.count(text)
    ms1 = sc1.find_matches(text)
    launches = dict(build.launches)
    print(f"launches in the slice run: {launches}", flush=True)
    for entry in KERNELS:
        check(launches[entry] >= 1, f"{entry} ran in the slice")

    t0 = time.perf_counter()
    oracle = machine.match_stream(machine.initiate(), text, parallel=False)
    oracle_s = time.perf_counter() - t0
    check(n == oracle, f"count {n} equals the host oracle {oracle}")
    check(len(ms) == n, f"find_matches has {len(ms)} matches, count {n}")
    check(n1 == n, f"step_k=1 count {n1} equals {n}")
    check(np.array_equal(ms1.ends, ms.ends), "step_k=1 match ends equal")
    idx = np.random.default_rng(2).choice(len(ms), min(1000, len(ms)),
                                          replace=False)
    for i in idx.tolist():
        kw = bytes(ms.match_for(int(ms.end_states[i])).letters)
        check(text[int(ms.starts[i]):int(ms.ends[i]) + 1] == kw,
              f"match {i} spells its keyword")
    count_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        check(sc.count(text) == n, "repeat count")
        count_times.append(time.perf_counter() - t0)
    find_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        check(len(sc.find_matches(text)) == n, "repeat find_matches")
        find_times.append(time.perf_counter() - t0)
    mib = len(text) / 2 ** 20
    print(f"slice: count {n} == host oracle ({oracle_s:.2f} s); "
          f"count() first {count_s:.4f} s, then "
          f"{', '.join(f'{t:.4f}' for t in count_times)} s = "
          f"{mib / min(count_times):.1f} MiB/s; find_matches() first "
          f"{find_s:.4f} s, then {', '.join(f'{t:.4f}' for t in find_times)}"
          f" s = {mib / min(find_times):.1f} MiB/s; {len(ms)} matches",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[entry],
         "max_abs_err": max(r["max_abs_err"] for r in kern[entry].values()),
         "ms": kern[entry]["raw_u8"]["ms"],
         "plain_ms": kern[entry]["raw_u8"]["plain_ms"]}
        for entry, (name, src, rep) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
