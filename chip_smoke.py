"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's paths (aho_corasick_1975_tpu_torch) end to end on the
card, importing nothing of JAX:

1. build: compiles the CUDA kernels of csrc/ with nvcc (sm_90a);
2. golden: the he/she/his/hers example, count and find_matches;
3. kernels: K1-K4 each against its plain PyTorch version on the same
   inputs, at the slice's shapes (B = 16,384 streams of bench.py's
   dictionary and corpus), exact equality (tolerance 0), with times;
4. slice: bench.py's 1,000-keyword byte dictionary over its 64 MiB seeded
   corpus, through Machine.scanner(): count() against the native host
   scan, find_matches() (length equal to the count, a seeded sample of
   1,000 matches checked against the text), and a step_k=1 scanner (K1
   and K2) giving the same count and match ends;
5. batch kernels: K5 and K6 against their plain versions, exact, at
   BASELINE config 3's count_many shapes (k = 1, 64 blocks of 8,192 + 10
   of 256 documents), and K5 at the slice's k = 3 tables, with times;
6. count_many: BASELINE config 3 as benchmarks/bench_count_many.py builds
   it (10,000 keywords, 256 documents of 400,000 bytes): raw, id-path and
   resident-tensor batches give equal counts, every document equals the
   native host scan, and a step_k=1 scanner (K6) agrees;
7. sessions: the slice corpus fed in seeded chunks of 1 byte to 12 MiB:
   feed_count totals the count and the host scan, feed_matches' ends are
   find_matches' ends, and a checkpoint carried through
   save_machine/load_machine resumes to the same total;
8. refresh: benchmarks/bench_refresh.py's shape (10,000 random 7-letter
   keywords, k = 2, a 1,000,000-letter text): six rounds of 10 online
   keywords and then 940 at once, each followed by count() and
   find_matches() equal to a fresh scanner's and to the host scan.

Each of phases 4 and 6-8 runs with the launch counters set to 0 just
before it and read just after, and fails unless every kernel of its path
was launched. Prints the kernels' JSON line, the card's name and power
limit, and last the line {"ok": true, "device": {...}}. Any failure exits
non-zero, and so does a machine without CUDA.
"""

from __future__ import annotations

import io
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
CM_KEYWORDS, CM_DOCS, CM_DOC_LEN = 10_000, 256, 400_000   # BASELINE config 3
MAX_CHUNK = 12 << 20
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
    "ac_stepped_count_many": (
        "K5 stepped_count_many",
        "aho_corasick_1975_tpu_torch/csrc/stepped_scan.cu",
        "aho_corasick_1975_tpu/ops/multistep.py:320"),
    "ac_dense_count_many": (
        "K6 dense_count_many",
        "aho_corasick_1975_tpu_torch/csrc/dense_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_xla.py:248"),
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
        results[name] = compare(name, kernel, plain, args, ins,
                                f"B={B} L={L}")
    return results


def compare(name, kernel, plain, args, ins, shape: str) -> dict:
    """Each input of ``ins`` through the kernel and its plain version:
    exact equality, then the kernel's mean time over 10 runs and the plain
    version's over 2 (CUDA events)."""
    res = {}
    for kind, extra in ins.items():
        got = kernel(*args, *extra)
        torch.cuda.synchronize()
        want = plain(*args, *extra)
        err = max_abs_err(got, want)
        check(err == 0, f"{name} ({kind}) equals its plain version")
        ms = cuda_ms(lambda: kernel(*args, *extra), 10)
        plain_ms = cuda_ms(lambda: plain(*args, *extra), 2)
        res[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"kernel {name} {kind} {shape}: {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, max_abs_err {err}", flush=True)
    return res


def driven(build, entries, what: str, fn):
    """fn() with the launch counters set to 0 just before it and read just
    after; fails unless every kernel of ``entries`` was launched. Returns
    (fn's result, the launches)."""
    build.reset_launches()
    out = fn()
    launches = dict(build.launches)
    print(f"launches in the {what} run: {launches}", flush=True)
    for entry in entries:
        check(launches[entry] >= 1, f"{entry} ran in the {what} run")
    return out, launches


def config3_setup(act):
    """benchmarks/bench_count_many.py's ByteMachine (10,000 ` word `
    keywords) and its 256 documents of 400,000 bytes."""
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    m = act.ByteMachine()
    seen = set()
    while len(seen) < CM_KEYWORDS:
        w = bytes(rng.choice(letters[:-1], rng.integers(4, 10)))
        if w not in seen:
            seen.add(w)
            m.insert_keyword(b" " + w + b" ")
    docs = [bytes(rng.choice(letters, CM_DOC_LEN)) for _ in range(CM_DOCS)]
    return m, docs


def batch_tm(docs, L: int, dtype, encode=None) -> np.ndarray:
    """A time-major [L, len(docs)] batch, one document per column (raw
    bytes, or ``encode``'s letter ids), padded with 0."""
    tm = np.zeros((L, len(docs)), dtype)
    for j, d in enumerate(docs):
        e = np.frombuffer(d, np.uint8) if encode is None else encode(d)
        tm[:len(e), j] = e
    return tm


def phase_batch_kernels(sc, docs, sc3, text: bytes) -> dict:
    """K5 and K6 against their plain versions at config 3's count_many
    shapes (its L bucket of 524,288 split into c blocks of Lp with the
    halo of 10), raw uint8 and int32 ids; K5 also on the slice's k = 3
    tables over 256 documents cut from the slice corpus."""
    from aho_corasick_1975_tpu_torch.ops import multistep, scan_dense
    st, snap = sc._stepped, sc._snap
    check(st is not None and st.k == 1, "config 3's packed table has k=1")
    B = len(docs)
    L = next(sc._length_buckets(np.array([CM_DOC_LEN]), 128))[0]
    c, Lp = sc._split_for(L, B, 128)
    lut = snap.place(sc._get_lut("byte")[3])
    ins = {"raw_u8": (snap.place(batch_tm(docs, L, np.uint8)), lut),
           "ids_i32": (snap.place(batch_tm(docs, L, np.int32, sc.encode)),
                       None)}
    shape = f"L={L} B={B} c={c} Lp={Lp}"
    res = {
        "ac_stepped_count_many": compare(
            "ac_stepped_count_many", multistep.stepped_count_many,
            multistep.stepped_count_many_plain,
            (snap.packed, st.V, st.k, st.count_bits, sc._halo_steps, c, Lp),
            ins, shape + f" k=1 halo={sc._halo_sym}"),
        "ac_dense_count_many": compare(
            "ac_dense_count_many", scan_dense.dense_count_many,
            scan_dense.dense_count_many_plain,
            (snap.dflat, snap.nb_out, sc.V, sc.halo, c, Lp), ins,
            shape + f" halo={sc.halo}")}
    st3, snap3 = sc3._stepped, sc3._snap
    L3 = min(len(text) // B, 1 << 18) // st3.k * st3.k
    tm3 = np.frombuffer(text[:B * L3], np.uint8).reshape(B, L3).T.copy()
    c3, Lp3 = sc3._split_for(L3, B, 128 * st3.k)
    k3 = compare("ac_stepped_count_many", multistep.stepped_count_many,
                 multistep.stepped_count_many_plain,
                 (snap3.packed, st3.V, st3.k, st3.count_bits,
                  sc3._halo_steps, c3, Lp3),
                 {"slice_k3_raw_u8": (snap3.place(tm3),
                                      snap3.place(sc3._get_lut("byte")[3]))},
                 f"L={L3} B={B} c={c3} Lp={Lp3} k={st3.k} "
                 f"halo={sc3._halo_sym}")
    res["ac_stepped_count_many"].update(k3)
    return res


def best_s(fn, reps: int = 3):
    """(best wall seconds of reps runs after a warm-up, last result)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_count_many(build, m, docs) -> dict:
    """BASELINE config 3 through count_many: raw bytes (K5), the id path,
    a resident int32 [L, B] tensor, and a step_k=1 scanner (K6), each
    against the native host scan of every document."""
    sc = m.scanner(n_streams=N_STREAMS)
    sc_id = m.scanner(n_streams=N_STREAMS, device_encode=False)
    sc1 = m.scanner(n_streams=N_STREAMS, step_k=1)
    resident = sc._snap.place(batch_tm(docs, CM_DOC_LEN, np.int32,
                                       sc.encode))
    legs = {"raw": (sc, docs, "count_many_raw"),
            "ids": (sc_id, docs, "count_many"),
            "resident": (sc, resident, "count_many_device"),
            "step_k=1 raw": (sc1, docs, "count_many_raw")}

    def run():
        out = {}
        for leg, (scanner, batch, op) in legs.items():
            out[leg] = scanner.count_many(batch)
            check(scanner.stats["last_op"] == op, f"{leg} took {op}")
        return out

    got, launches = driven(build, ("ac_stepped_count_many",
                                   "ac_dense_count_many"), "count_many", run)
    t0 = time.perf_counter()
    oracle = np.asarray([m.match_stream(m.initiate(), d, parallel=False)
                         for d in docs], np.int64)
    oracle_s = time.perf_counter() - t0
    for leg, counts in got.items():
        check(np.array_equal(counts, oracle),
              f"count_many {leg} equals the host oracle per document")
    mib = CM_DOCS * CM_DOC_LEN / 2 ** 20
    L = next(sc._length_buckets(np.array([CM_DOC_LEN]), 128))[0]
    stage_s, _ = best_s(lambda: batch_tm(docs, L, np.uint8))
    parts = []
    for leg, (scanner, batch, _) in legs.items():
        t, _ = best_s(lambda: scanner.count_many(batch))
        parts.append(f"{leg} {t * 1e3:.1f} ms = {mib / t:.1f} MiB/s")
    print(f"count_many config 3 ({CM_DOCS} x {CM_DOC_LEN} bytes, "
          f"{m.n_states} states, k={sc.step_k}, {int(oracle.sum())} "
          f"matches == host oracle, {oracle_s:.2f} s): {'; '.join(parts)}; "
          f"host column fill of the raw batch {stage_s * 1e3:.1f} ms",
          flush=True)
    return launches


def phase_sessions(act, build, machine, sc, text: bytes, n: int,
                   ends: np.ndarray, count_s: float) -> None:
    """The slice corpus in seeded chunks of 1 byte to 12 MiB through
    feed_count and feed_matches, and a checkpoint resumed on a machine
    carried through save_machine/load_machine."""
    rng = np.random.default_rng(3)
    cuts = [0]
    while cuts[-1] < len(text):
        size = int(np.exp(rng.uniform(0, np.log(MAX_CHUNK))))
        cuts.append(min(len(text), cuts[-1] + max(1, size)))
    chunks = [text[a:b] for a, b in zip(cuts, cuts[1:])]
    half = len(chunks) // 2

    def run():
        s = sc.session()
        t0 = time.perf_counter()
        for ch in chunks:
            s.feed_count(ch)
        feed_s = time.perf_counter() - t0
        s2 = sc.session()
        got_ends = np.concatenate([s2.feed_matches(ch).ends for ch in chunks])
        s3 = sc.session()
        for ch in chunks[:half]:
            s3.feed_count(ch)
        state = s3.checkpoint()
        blob = io.BytesIO()
        act.save_machine(machine, blob)
        blob.seek(0)
        restored = act.StreamSession.restore(
            act.load_machine(blob).scanner(n_streams=N_STREAMS), state)
        for ch in chunks[half:]:
            restored.feed_count(ch)
        return s.total, feed_s, s2.total, got_ends, restored.total

    (total, feed_s, n_matches, got_ends, resumed), _ = driven(
        build, ("ac_stepped_count", "ac_stepped_emit"), "sessions", run)
    check(total == n, f"feed_count total {total} equals count() {n}")
    check(n_matches == n and np.array_equal(got_ends, ends),
          "feed_matches' ends equal find_matches' ends")
    check(resumed == n, f"resumed total {resumed} equals {n}")
    print(f"sessions: {len(chunks)} chunks of {min(map(len, chunks))} to "
          f"{max(map(len, chunks))} bytes; feed_count total {total} == "
          f"count() == host oracle in {feed_s * 1e3:.1f} ms (one count() "
          f"{count_s * 1e3:.1f} ms); feed_matches ends == find_matches "
          f"ends; checkpoint at chunk {half} through save_machine/"
          f"load_machine resumed to {resumed}", flush=True)


def phase_refresh(act, build) -> None:
    """benchmarks/bench_refresh.py's shape: 10,000 random 7-letter
    keywords, step_budget_bytes=512 MiB (k = 2), n_streams=8192, a
    1,000,000-letter text; six rounds of +10 online keywords, then +940.
    Random 7-letter words seldom occur in random text, so each round also
    checks a probe text that holds every 10th base keyword and every
    online one."""
    rng = np.random.default_rng(42)

    def kw(n):
        return "".join(chr(ord("a") + c) for c in rng.integers(0, 26, n))

    base = [kw(7) for _ in range(10_000)]
    online = [kw(7) for _ in range(1_000)]
    text = "".join(kw(1) for _ in range(1_000_000))
    probe = " ".join(base[::10] + online)
    m = act.Machine()
    for w in base:
        m.insert_keyword(w)
    spec = dict(n_streams=8192, step_budget_bytes=512 * 1024 * 1024)
    sc = m.scanner(**spec)
    check(sc.step_k == 2, f"refresh scanner has k=2 (got {sc.step_k})")
    print(f"refresh: {m.n_states} states, V={sc.V}, k={sc.step_k}, "
          f"counts {sc.count(text)}, {sc.count(probe)} (probe)", flush=True)

    def refreshed(tag):
        t0 = time.perf_counter()
        status = sc.refresh()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fresh = m.scanner(**spec)
        n_fresh = fresh.count(text)
        fresh_ms = (time.perf_counter() - t0) * 1e3
        counts = []
        for t in (text, probe):
            n = sc.count(t)
            oracle = m.match_stream(m.initiate(), t, parallel=False)
            check(n == fresh.count(t) == oracle,
                  f"{tag}: count {n} equals a fresh scanner's and the host "
                  f"oracle {oracle}")
            a, b = sc.find_matches(t), fresh.find_matches(t)
            check(len(a) == n and np.array_equal(a.ends, b.ends)
                  and np.array_equal(a.end_states, b.end_states)
                  and np.array_equal(a.indices, b.indices),
                  f"{tag}: find_matches equals a fresh scanner's")
            counts.append(n)
        snap_s = sc._snap.last_refresh.get("seconds")
        print(f"refresh {tag}: returned {status} "
              f"({'in place' if status else 'rebuilt'}) in {ms:.1f} ms "
              f"(device snapshot "
              f"{'rebuilt' if snap_s is None else f'{snap_s * 1e3:.1f} ms'}"
              f"), rows {sc.stats.get('refresh_rows')}, cells "
              f"{sc.stats.get('refresh_cells')}; fresh scanner + count "
              f"{fresh_ms:.1f} ms; text and probe counts {counts} == fresh "
              f"== host oracle; find_matches == fresh", flush=True)

    def run():
        for i in range(6):
            for w in online[i * 10:(i + 1) * 10]:
                m.insert_keyword(w)
            refreshed(f"+10 #{i}")
        for w in online[60:]:
            m.insert_keyword(w)
        refreshed("+940")

    driven(build, ("ac_stepped_count", "ac_stepped_emit"), "refresh", run)


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
    def slice_run():
        t0 = time.perf_counter()
        n = sc.count(text)
        count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ms = sc.find_matches(text)
        find_s = time.perf_counter() - t0
        return n, count_s, ms, find_s, sc1.count(text), sc1.find_matches(text)

    (n, count_s, ms, find_s, n1, ms1), launches = driven(
        build, list(KERNELS)[:4], "slice", slice_run)
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

    # 5. K5 and K6 against their plain versions at config 3's shapes
    t0 = time.perf_counter()
    m3, docs = config3_setup(act)
    sc_cm = m3.scanner(n_streams=N_STREAMS)
    print(f"config 3: {m3.n_states} states, V={sc_cm.V}, "
          f"step_k={sc_cm.step_k}, halo={sc_cm.halo}, packed "
          f"{sc_cm._snap.packed.numel() * 4} bytes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kern.update(phase_batch_kernels(sc_cm, docs, sc, text))
    del sc_cm

    # 6. count_many at config 3
    launches.update({e: v for e, v in phase_count_many(build, m3, docs).items()
                     if e in ("ac_stepped_count_many", "ac_dense_count_many")})
    del m3, docs

    # 7. sessions over the slice corpus
    phase_sessions(act, build, machine, sc, text, n, ms.ends,
                   min(count_times))

    # 8. refresh at bench_refresh.py's shape
    phase_refresh(act, build)

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
