"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's paths (aho_corasick_1975_tpu_torch) end to end on the
card, importing nothing of JAX:

1. build: compiles the CUDA kernels of csrc/ with nvcc (sm_90a);
2. golden: the he/she/his/hers example, count and find_matches;
3. kernels: K1-K4 each against its plain PyTorch version on the same
   inputs, at the slice's shapes (B = 16,384 streams of bench.py's
   dictionary and corpus), exact equality (tolerance 0), with times;
   K1-K4 also forced to every split P of SPLIT_SWEEP (sub-streams a
   stream; P = 1 is one thread a stream), exact at each, with their times
   by P, K1 and K2 also with their tables forced through the read-only
   path (``global_table``) where their launcher stages them on the SM; K4
   also at its boundary case (the slice's longest keyword ending before
   each sub-stream's first gram: exact over its warm-up, differing in
   exactly those grams over K3's);
4. slice: bench.py's 1,000-keyword byte dictionary over its 64 MiB seeded
   corpus, through Machine.scanner(): count() against the native host
   scan, find_matches() (length equal to the count, a seeded sample of
   1,000 matches checked against the text), and a step_k=1 scanner (K1
   and K2) giving the same count and match ends; then the staging ring
   (models/staging.py, ``phase_staging``): the pageable and the pinned
   upload of the slice's bytes and their host fill into the ring, each
   alone; count() from bytes, best of 5, each run equal to the host
   oracle, beside them; a torch.profiler run's device busy share and the
   copy stream's copies that overlap a kernel or the next chunk's host
   fill; the pipeline's chunk (2-16 MiB) and ring depth (2-4) swept, and
   the count without the pipeline, exact at every point; a stale-slot
   case (a short last chunk of prime length in a slot that held keyword
   bytes); the slice as a str (int32 code points through the pipeline)
   and a step_k=1 scanner's count (K1's raw form through it);
   find_matches() and the sessions' 121 chunks, timed;
5. batch kernels: K5 and K6 against their plain versions, exact, at
   BASELINE config 3's count_many shapes (k = 1, 64 blocks of 8,192 + 10
   of 256 documents), K5 at the slice's k = 3 tables and K6 at its
   step_k=1 tables (256 documents cut from the slice), with times; K5 and
   K6 also forced to every split P, exact at each, with their times by P;
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
   find_matches() equal to a fresh scanner's and to the host scan;
9. sparse: the prefilter. (a) benchmarks/bench_sparse_e2e.py's signature
   hunt: 8 byte keywords planted at density 1e-3 in 256 MiB of 0x00,
   prefilter="on": count() (raw elision, K7), find_matches() bounded and
   not (elided K8 windows) against the host scan and a prefilter="off"
   scanner, with end-to-end times, the upload of the same bytes and the
   device's busy share, and a step_k=1 scanner's count() of the bytes and
   of a letter-id tensor (K7's dense body, elided and over the index
   list); (b) benchmarks/bench_sparse.py's 64 Mi resident
   ids at densities 1e-2, 1e-3, 1e-4, as host int32 arrays (host filter)
   and CUDA tensors (device block filter), auto k and step_k=1, and
   scan_states_sequential and the time-major K2 (no scanner calls it);
   (c) the "auto" gate declining on the slice corpus (K3 and K4 run, K7
   does not) and find_matches(max_hits) of a step_k=1 scanner through
   K8's stream form; (d) K7, K8 and the K2 modes against their plain
   versions at those shapes; each K7 and K8 form is held at least once on
   the hunt's windows, whose plain answer must be non-zero. (The resident
   ids, as bench_sparse.py builds them, hold no match; K7 dense is also
   held on them with the resident words planted.) K8 is also forced
   to every split P (the stream form at the slice, also through the
   read-only path; the window form on the hunt's windows), exact at each,
   and its two passes and the sync and cumsum between them are timed
   apart (``passes``); K2's time-major form is forced to every split P,
   and its one-thread form (one chain, P = 1) also runs with its tables
   through the read-only path (``ms_read_only``). K7 dense runs at its
   pick and at every forced split P on the hunt's elided and index-list
   windows and on the resident 1e-3 windows with the resident words
   planted in a quarter of their runs (``planted_resident``: same live
   blocks, a non-zero plain total), exact at each against its plain
   version, with its device times by torch.profiler (``device_ms`` at the
   pick, ``ms_by_split``) and its call split into the wrapper's,
   build.launch's and the C entry point's enqueue (``enqueue_ms``).
10. two-table: the slice's dictionary with the two-table k-gram form
   forced (as the tests force it): count() of a letter-id tensor and of
   the bytes (K9's stream form on host-encoded ids) and count_many of 256
   documents cut from the slice (its batch form), against the host scan;
11. hybrid: engine="hybrid" on the slice: count() from bytes (pipelined,
   K11's raw form) and from a letter-id tensor, a session over the
   slice's chunks, a refresh() of the next 10 ranked words and a count,
   against the host scan; B1, B2 and S_pad printed;
12. mxu: engine="mxu" with the largest prefix of bench.py's ranked words
   that fits it (S_pad <= 512): count() of the corpus from bytes and as a
   tensor, count_many of config 3's 256 documents (K10's batch form), and
   the signature hunt with prefilter="on" from bytes (elided windows) and
   as a tensor (index list), against the host scan;
13. calibration: calibrate=True on the slice's and the MXU dictionary's
   scanners: the probe's times and winner; a second scanner of the same
   geometry does not probe;
14. engine kernels: every form of K9, K10 and K11 against its plain
   version, exact, on data whose plain total is non-zero, with times
   (K11 also over the corpus repeated to fill every column, since
   count()'s zero padding is its MMA half's; there that half's own total
   must be non-zero); K11's time beside its two halves alone (the MMA
   half as K11's launch with B1 = 0, the gather half as K3's), each
   equal to K11's own columns, and beside K3's on the slice's tables, and
   K10's beside K3's on the MXU dictionary's, each at the same B and L, in
   ns a step too; K9 (stream and batch forms) and K11 (text in every
   column) also forced to every split P, exact at each, with their times
   by P. (probe_mxu_rows.py times K10 and K11 at other rows per warp.)
15. mesh: every ShardedScanner path on 4 logical shards of cuda:0, each
   shard's launches checked, beside DenseScanner, and one count through
   a one-rank NCCL group;
16. K12 against its plain version and K2's one-thread form, also over
   the slice's dictionary;
17. examples: each script of examples_torch/ loaded by path and run as
   main(device="cuda") with its stdout captured and the launch counters
   set to 0 just before and read just after, its result held against the
   port's native host oracle: the demo's golden line; generic Test 1's
   events against the host cursor's, Test 3's three totals against the
   native host scan of the same ids (its dictionaries of 113,402 to
   311,968 states, past uint16 state ids, which "auto" scans through the
   packed k = 1 table: K3 at k = 1), then a step_k=1 scanner of Test 3's
   last dictionary through K1 with its tables in device memory
   (``build.dense_tables``), and K1 and K3 at those tables and ids
   against their plain versions (their bounds at the entries the walk
   reads); the needle hunt's 12 matches, its events and its restore; the
   serving demo's replies against the host cursor's; the sharded demo's
   total against a DenseScanner's and the host scan's, and its first
   events; the host-parallel demo's own asserts.

Each of phases 4, 6-8, 9's (a)-(b) and (c), 10-12 and each example of 17
runs with the launch counters set to 0 just before it and read just after,
and fails unless every kernel of its path (and every input form named) was
launched.
Every kernel comparison gives its bound: every tensor of the call read
once and its output written once over 3.35 TB/s (a capacity-padded
table at its real states' rows, a stream read through an index list at
its listed windows), against the int8 tensor-core operations the data
needs at least (K10, K11: one m16n8k32 product, all planes at once, per
16 rows and step, the densest the instruction allows) over 1,979 TOPS.
Every kernel of the JSON line also gives the sub-streams per column its
launch picked (``split``, the split kernels K1-K3, K5, K6, K8, K9, K11),
its ns a step of one column's one-thread chain (``ns_per_step``), its
times by forced split (``ms_by_split``, the split kernels; K1's, K2's
and K8's stream forms also ``ms_by_split_read_only``), K2's one-thread form
through the read-only path (``ms_read_only``), K8's pass times
(``passes``), the most registers and spill bytes ptxas gave its
kernels (``registers``, the split ones and K12's), whose every line is
printed before it, and for K12 its three kernels' device times
(``phases``, torch.profiler) and their sum (``device_ms``) beside the
call's ``ms``, the bound of its T*S lookups at 32 a clock an SM
(``lookup_bound_ms``) beside its bytes bound, K2's one-thread form on the
same ids (``seq_ms``) and its time over the slice's dictionary
(``slice_dictionary_ms``). Prints the kernels' JSON line, a {"plain_ops": ...} line (the
plain-torch steps no kernel replaces, each with its card time a call and
bytes bound: ``plain_ops``), the mesh line, the examples line (each
example's seconds, launches and checks), the card's name and power
limit, and last the line {"ok": true, "device": {...}}; the staging
phase's {"staging": ...} line comes before the kernels' line. Any failure
exits non-zero, and so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
SPARSE_KEYWORDS = [b"needle", b"haystack", b"signature", b"marker",
                   b"beacon", b"sentinel", b"flagged", b"tracer"]
SPARSE_BYTES, SPARSE_DENSITY = 256 << 20, 1e-3   # bench_sparse_e2e.py
RESIDENT_WORDS = ["needle", "haystack", "signature", "marker", "beacon",
                  "sentinel", "flagged", "tracer"]  # bench_sparse.py
RESIDENT_IDS = 64 << 20
RESIDENT_DENSITIES = (1e-2, 1e-3, 1e-4)
SEQ_SYMBOLS = 1 << 15   # scan_states_sequential: one thread
TM_SIDE = 4096          # the time-major K2 batch: [TM_SIDE, TM_SIDE] ids
TWO_TABLE_DOC = 12_288  # K9's batch form against its plain version
MESH_SHARDS, MESH_STREAMS = 4, 4096   # 16,384 streams in all, as the slice
ASSOC_T = 1 << 20       # K12's stream
ASSOC_SLICE_T = 1 << 16   # K12 over the slice's dictionary
# phase_staging: the pipeline's chunk (symbols) and ring depth swept
STAGING_CHUNKS = (2 << 20, 4 << 20, 8 << 20, 16 << 20)
STAGING_DEPTHS = (2, 3, 4)
STAGING_RUNS = 5        # count() from bytes: best of these runs
STAGING_ROUNDS = 7      # the sweep's points, timed in turns
GOLDEN = "To ushers: he found his pencil, but she could not find hers."
GOLDEN_LINE = " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"
# entry point, or "entry/form" for a form counted in build.form_launches
# -> (name, source, TPU-side function it replaces)
KERNELS = {
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
    "ac_dense_states/seq": (   # K2 with B = 1, counted as a form
        "K2 sequential_states (one thread)",
        "aho_corasick_1975_tpu_torch/csrc/dense_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_xla.py:33"),
    "ac_dense_states_tm": (
        "K2 blocked_states (time-major)",
        "aho_corasick_1975_tpu_torch/csrc/dense_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_xla.py:51"),
    "ac_sparse_count": (
        "K7 sparse_count (dense windows, K1's lanes)",
        "aho_corasick_1975_tpu_torch/csrc/sparse_scan.cu",
        "aho_corasick_1975_tpu/ops/sparse.py:170"),
    "ac_sparse_count_stepped": (
        "K7 sparse_count_stepped",
        "aho_corasick_1975_tpu_torch/csrc/sparse_scan.cu",
        "aho_corasick_1975_tpu/ops/sparse.py:374"),
    "ac_dense_hits": (
        "K8 dense_hits (stream form)",
        "aho_corasick_1975_tpu_torch/csrc/sparse_scan.cu",
        "aho_corasick_1975_tpu/ops/hits.py:46"),
    "ac_window_hits": (
        "K8 window_hits (window form)",
        "aho_corasick_1975_tpu_torch/csrc/sparse_scan.cu",
        "aho_corasick_1975_tpu/ops/sparse.py:200"),
    "ac_stepped_count_2t": (
        "K9 stepped_count_2t (two-table k-gram count)",
        "aho_corasick_1975_tpu_torch/csrc/stepped_scan.cu",
        "aho_corasick_1975_tpu/ops/multistep.py:366"),
    "ac_mxu_count": (
        "K10 mxu_count (int8 mma.sync, (state, letter) one-hot x planes)",
        "aho_corasick_1975_tpu_torch/csrc/mxu_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_mxu.py:79"),
    "ac_hybrid_count": (
        "K11 hybrid_count (gather and MMA blocks in one launch)",
        "aho_corasick_1975_tpu_torch/csrc/mxu_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_hybrid.py:52"),
    "ac_assoc_scan": (
        "K12 assoc_scan (chunked transition-function composition)",
        "aho_corasick_1975_tpu_torch/csrc/assoc_scan.cu",
        "aho_corasick_1975_tpu/ops/scan_assoc.py:29"),
}
# K7 and K8 input forms every sparse run must launch (build.form_launches)
SPARSE_FORMS = ("ac_sparse_count/idx", "ac_sparse_count/elided",
                "ac_sparse_count_stepped/idx",
                "ac_sparse_count_stepped/elided", "ac_window_hits/idx",
                "ac_window_hits/elided")


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
    """bench.py's machine (its N_KEYWORDS most frequent words as ` word `
    byte keywords), its corpus tiled to TARGET_BYTES, and every word of
    the corpus as a keyword, in bench.py's frequency order."""
    norm = corpus()
    freq: dict = {}
    for w in norm.split():
        freq[w] = freq.get(w, 0) + 1
    ranked = [b" " + w.encode() + b" "
              for w in sorted(freq, key=lambda w: (-freq[w], w))]
    reps = max(1, TARGET_BYTES // len(norm))
    return (keyword_machine(act, ranked[:N_KEYWORDS]),
            ((norm + " ") * reps).encode(), ranked)


def keyword_machine(act, keywords):
    machine = act.Machine()
    for w in keywords:
        machine.insert_keyword(w)
    return machine


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


# The card's peaks (H100 SXM data sheet): device
# memory bytes/s and dense int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
MMA_OPS = 2 * 16 * 32 * 8   # one mma.sync m16n8k32 (multiply-adds x 2)


def nbytes(x) -> int:
    """Bytes of the tensors in x (a tensor, or nested tuples of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(nbytes(y) for y in x)
    return 0


def needs(sc, halo: int = 0, L_blk: int = 0):
    """The bytes the data needs of tensors a kernel reads only in part:
    (tensor, bytes) pairs for the scanner's capacity-padded tables (their
    real states' rows) and, for a window form given an index list, the
    stream under it (its listed windows of halo + L_blk ids). Returns a
    function of a compared input's tensors."""
    snap, S, st = sc._snap, sc.tables.n_states, sc._stepped
    rows = [(snap.dflat, S * sc.V * 4), (snap.nb_out, S * 4)]
    for t in (snap.packed, snap.delta_k, snap.cnt_k):
        if t is not None:
            rows.append((t, S * st.Vk * 4))

    def pairs(*extra):
        out = list(rows)
        if (L_blk and len(extra) > 1 and extra[0].dim() == 1
                and extra[1] is not None):
            out.append((extra[0], extra[1].numel() * (halo + L_blk) * 4))
        return out
    return pairs


def moved_bytes(xs, need) -> int:
    """Bytes of the tensors in xs, each read or written once, with the
    tensors of ``need`` counted at their needed bytes."""
    total = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            total += moved_bytes(x, need)
        elif isinstance(x, torch.Tensor):
            part = [b for t, b in need if t is x]
            total += part[0] if part else nbytes(x)
    return total


def bound(moved: int, ops: int):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes moved over the memory rate and the int8 tensor
    operations over their peak."""
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT8_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def mma_ops(columns: int, rows: int) -> int:
    """The int8 operations the K10/K11 lookup needs at least: every step
    of each group of 16 columns multiplies the one-hot (state, letter) keys
    of its 16 rows, at best all in one 32-key tile, by the planes keyed so,
    all planes in one m16n8k32 product. Sixteen rows are the most one
    product serves, so this holds whatever rows per warp the kernels run
    (a warp of R rows multiplies one product per distinct tile among
    them)."""
    return MMA_OPS * (-(-columns // 16)) * rows


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, "kernel output shape")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# The plain-torch steps that no kernel replaces, on the paths that run
# them: the device block filter (prefilter counts of a resident tensor),
# the snapshot's refresh (its diff and writes), and find_matches'
# refinement of live grams (both forms). name -> {"calls", "ms", "bytes"}, summed over the calls
# timed by plain_ops.
PLAIN_OPS: dict = {}


@contextlib.contextmanager
def plain_ops(*expect: str):
    """Times every call of the plain-torch steps inside the block with
    CUDA events around it (the host work and syncs inside the call
    count), into PLAIN_OPS, with the bytes it must move: each tensor
    argument read once (the tables whole: their capacity rows), each
    output written once; the block filter reads the body and writes the
    order; a snapshot's refresh uploads the new 1-char tables, which bind
    it (its diff and writes run on the card). Fails unless each step named in `expect` was timed
    in the block, so that a renamed or rebound step cannot drop its row
    unnoticed."""
    from aho_corasick_1975_tpu_torch.models import scanner as msc
    from aho_corasick_1975_tpu_torch.models import snapshot as msnap
    from aho_corasick_1975_tpu_torch.ops import sparse
    marks = []

    def refine_bytes(a, out):
        return sum(nbytes(x) for x in a[5:] if isinstance(x, torch.Tensor)
                   and x.dim() > 0) + nbytes(out[:2])

    def filter_bytes(a, out):
        _, nB, L_blk, _ = a
        return 4 * nB * L_blk + nbytes(out[0])

    def refresh_bytes(a, out):
        return a[1].delta.nbytes + a[1].nb_outputs.nbytes

    def timed(name, orig, moved):
        def fn(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **k)
            e1.record()
            marks.append((name, e0, e1, moved(a, out)))
            return out
        return fn

    patches = [(msc, "hits_extract", refine_bytes),
               (msc, "hits_extract_dense", refine_bytes),
               (sparse, "block_filter", filter_bytes),
               (msnap.DeviceSnapshot, "refresh", refresh_bytes)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    try:
        for owner, attr, moved in patches:
            setattr(owner, attr, timed(attr, getattr(owner, attr), moved))
        yield
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
        torch.cuda.synchronize()
        for name, e0, e1, moved in marks:
            row = PLAIN_OPS.setdefault(name, {"calls": 0, "ms": 0.0,
                                              "bytes": 0})
            row["calls"] += 1
            row["ms"] += e0.elapsed_time(e1)
            row["bytes"] += moved
    timed_here = {name for name, *_ in marks}
    for name in expect:
        check(name in timed_here, f"plain_ops timed {name} in its block "
              f"(timed: {sorted(timed_here)})")


def plain_ops_line() -> dict:
    """PLAIN_OPS with each step's ms a call and bound (bytes)."""
    out = {}
    for name, row in PLAIN_OPS.items():
        n = row["calls"]
        out[name] = {"calls": n, "ms": row["ms"] / n,
                     "bytes": row["bytes"] / n,
                     "bound_ms": bound(row["bytes"] / n, 0)[0],
                     "bound_by": "bytes"}
    return out


def phase_kernels(sc, text: bytes, longest: bytes) -> dict:
    """K1-K4 against their plain versions at the slice's shapes, on the
    slice's tables and corpus: raw uint8 and int32 letter-id inputs,
    non-zero head_ids; K4 also at its boundary case (``emit_boundary``,
    over the dictionary's longest keyword)."""
    from aho_corasick_1975_tpu_torch.ops import hits, multistep, scan_dense
    st, snap = sc._stepped, sc._snap
    check(st is not None and st.k == 3, "the slice's packed table has k=3")
    B, L = N_STREAMS, KERNEL_L
    results = {}
    dense_in = stream_inputs(sc, text, sc.halo, B, L)
    step_in = stream_inputs(sc, text, sc._halo_sym, B, L)
    k1 = functools.partial(scan_dense.dense_count, **sc._dense_fields())
    k2 = functools.partial(scan_dense.dense_states, **sc._dense_fields())
    cases = {
        "ac_dense_count": (k1, scan_dense.dense_count_plain,
                           (snap.dflat, snap.nb_out, sc.V, sc.halo, B, L),
                           dense_in),
        "ac_dense_states": (k2, scan_dense.dense_states_plain,
                            (snap.dflat, sc.V, sc.halo, B, L), dense_in),
        "ac_stepped_count": (functools.partial(multistep.stepped_count,
                                               warm_steps=sc._warm_steps),
                             multistep.stepped_count_plain,
                             (snap.packed, st.V, st.k, st.count_bits,
                              sc._halo_steps, B, L), step_in),
        "ac_stepped_emit": (functools.partial(hits.stepped_emit,
                                              warm_steps=sc._emit_warm),
                            hits.stepped_emit_plain,
                            (snap.packed, st.V, st.k, st.count_bits,
                             sc._halo_steps, B, L), step_in),
    }
    grams = sc._halo_steps + L // st.k
    steps = {"ac_dense_count": sc.halo + L, "ac_dense_states": sc.halo + L,
             "ac_stepped_count": grams, "ac_stepped_emit": grams}
    for name, (kernel, plain, args, ins) in cases.items():
        results[name] = compare(name, kernel, plain, args, ins,
                                f"B={B} L={L}", need=needs(sc),
                                steps=steps[name])
    check(all(r["split"] > 1 for r in results["ac_stepped_emit"].values()),
          "K4 runs as sub-streams at the slice (build.splits)")
    emit_boundary(sc, text, cases["ac_stepped_emit"], longest)
    for name in ("ac_stepped_count", "ac_stepped_emit", "ac_dense_count",
                 "ac_dense_states"):
        kernel, plain, args, ins = cases[name]
        for kind, row in split_sweep(name, kernel, plain, args, ins,
                                     steps[name]).items():
            results[name][kind]["ms_by_split"] = row
    for name in ("ac_dense_count", "ac_dense_states"):
        for kind, row in split_sweep(name, *cases[name], steps[name],
                                     global_table=True).items():
            results[name][kind]["ms_by_split_read_only"] = row
    return results


def emit_boundary(sc, text: bytes, case, kw: bytes) -> None:
    """K4's boundary case at the slice's shapes: the dictionary's longest
    keyword kw (max_depth symbols, max_depth = 1 mod k) planted in every
    stream to end at the last symbol before each sub-stream's first body
    gram at the launcher's pick P, raw bytes and ids. K4 warmed up over
    the scanner's ceil(max_depth / k) grams equals its plain version;
    over K3's ceil((max_depth - 1) / k) the word of exactly those B*(P-1)
    grams differs (the state before them is the keyword's end, which
    max_depth - 1 symbols from the root cannot reach)."""
    from aho_corasick_1975_tpu_torch.ops import build
    kernel, plain, args, _ = case
    st = sc._stepped
    B, L, k, hs = N_STREAMS, KERNEL_L, st.k, sc._halo_steps
    check(len(kw) == sc.tables.max_depth and len(kw) % k == 1,
          f"the slice's longest keyword {kw!r} is max_depth "
          f"{sc.tables.max_depth} deep, 1 mod k = {k}")
    n_body = L // k
    for kind in ("raw_u8", "ids_i32"):
        kernel(*args, *stream_inputs(sc, text, sc._halo_sym, B, L)[kind])
        P = build.splits["ac_stepped_emit"]
        j0 = hs + n_body * np.arange(1, P) // P
        ends = (np.arange(B)[:, None] * L + j0[None, :] * k).ravel()
        extra = stream_inputs(sc, text, sc._halo_sym, B, L, seed=3,
                              plant=(ends, kw))[kind]
        want = plain(*args, *extra)
        got = kernel(*args, *extra, split=P)
        torch.cuda.synchronize()
        check(max_abs_err(got, want) == 0,
              f"K4 ({kind}) at the boundary case equals its plain version")
        short = kernel(*args, *extra, split=P, warm_steps=sc._warm_steps)
        n_diff = int((short[0] != want[0]).sum())
        mask = (1 << st.count_bits) - 1
        check(n_diff == B * (P - 1) and torch.equal(short[0] & mask,
                                                    want[0] & mask),
              f"K4 ({kind}) over K3's warm-up differs in exactly the "
              f"{B * (P - 1)} planted first grams ({n_diff})")
        print(f"K4 boundary case ({kind}): {kw!r} ends before each of "
              f"{B * (P - 1)} sub-streams at P={P}: exact over "
              f"{sc._emit_warm} grams of warm-up, {n_diff} words differ "
              f"over K3's {sc._warm_steps}", flush=True)


def stream_inputs(sc, text: bytes, halo: int, B: int, L: int,
                  seed: int = 1, fill: bool = False, plant=None) -> dict:
    """A kernel's stream inputs from the corpus: raw uint8 bytes with the
    scanner's byte LUT and seeded non-zero head ids, and the same stream as
    int32 letter ids. The corpus is zero-padded to B*L bytes as count()
    lays it out or, with ``fill``, repeated to fill every column. ``plant``
    (ends, keyword) writes the keyword to end just before each of the ends
    (buffer offsets)."""
    rng = np.random.default_rng(seed)
    snap = sc._snap
    lut_host = sc._get_lut("byte")[3]
    raw = np.zeros(halo + B * L, np.uint8)
    src = np.frombuffer(text, np.uint8)
    if fill:
        src = np.tile(src, -(-B * L // len(src)))
    n = min(len(src), B * L)
    raw[halo:halo + n] = src[:n]
    if plant is not None:
        ends, kw = plant
        for i, ch in enumerate(kw):
            raw[ends - len(kw) + i] = ch
    head = rng.integers(1, sc.V, halo).astype(np.int32)
    ids = lut_host[raw].astype(np.int32)
    ids[:halo] = head
    return {"raw_u8": (snap.place(raw), snap.place(lut_host),
                       snap.place(head)),
            "ids_i32": (snap.place(ids), None, None)}


def compare(name, kernel, plain, args, ins, shape: str,
            hits=False, ops=None, need=None, steps=None) -> dict:
    """Each input of ``ins`` through the kernel and its plain version:
    exact equality, then the kernel's mean time over 10 runs and the plain
    version's over 2 (CUDA events), and the bound: every tensor of the
    call read once and its output written once, those of
    ``need(*extra)`` at the bytes the data needs of them (``needs``), and
    ``ops(*extra)`` int8 tensor operations (none but for K10, K11).
    With ``hits``, the plain version's output (its entries ``hits`` where
    that is a slice) must hold a match (a non-zero count), so that a
    kernel writing zeros there cannot pass. ``steps``: the dependent
    steps of one column's one-thread chain, for the kernel's ns a step;
    a stepped launch (K3, K5, K9, K11) also gives the sub-streams per
    column it picked (``build.splits``)."""
    from aho_corasick_1975_tpu_torch.ops import build
    res = {}
    for kind, extra in ins.items():
        got = kernel(*args, *extra)
        torch.cuda.synchronize()
        want = plain(*args, *extra)
        err = max_abs_err(got, want)
        check(err == 0, f"{name} ({kind}) equals its plain version")
        out = want[-1] if isinstance(want, tuple) else want
        total = int((out[hits] if isinstance(hits, slice) else out)
                    .long().sum())
        check(not hits or total > 0, f"{name} ({kind}) is checked on "
              f"windows that hold matches (plain total {total})")
        ms = cuda_ms(lambda: kernel(*args, *extra), 10)
        plain_ms = cuda_ms(lambda: plain(*args, *extra), 2)
        moved = moved_bytes((args, extra, got), need(*extra) if need else ())
        bound_ms, bound_by = bound(moved, ops(*extra) if ops else 0)
        split = build.splits.get(name.split("/")[0])
        res[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "split": split,
                     "ns_per_step": ms * 1e6 / steps if steps else None}
        print(f"kernel {name} {kind} {shape}: {ms:.4f} ms"
              f"{f' ({ms * 1e6 / steps:.1f} ns a step)' if steps else ''}"
              f"{f' at P={split}' if split else ''}, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max_abs_err {err}, plain total {total}", flush=True)
    return res


SPLIT_SWEEP = (1, 2, 4, 8, 16, 32)


def split_sweep(name, kernel, plain, args, ins, steps: int, reps: int = 30,
                **kw) -> dict:
    """Each input of ``ins`` through the split kernel forced to every P
    of SPLIT_SWEEP (P = 1: one thread a column, the unsplit launch), with
    the keyword arguments ``kw`` (K1, K8: ``global_table=True``, the
    tables through the read-only path): exact against the plain version at
    each, and the kernel's mean ms (CUDA events, ``reps`` runs) by P,
    beside the launcher's own pick (``compare``)."""
    out = {}
    for kind, extra in ins.items():
        want = plain(*args, *extra)
        row = {}
        for P in SPLIT_SWEEP:
            fn = functools.partial(kernel, split=P, **kw)
            got = fn(*args, *extra)
            torch.cuda.synchronize()
            check(max_abs_err(got, want) == 0,
                  f"{name} ({kind}) at split {P} {kw} equals its plain "
                  f"version")
            row[P] = cuda_ms(lambda: fn(*args, *extra), reps)
        out[kind] = row
        print(f"kernel {name} {kind}{f' {kw}' if kw else ''} by split "
              f"(exact at each): " + ", ".join(
                  f"P={P} {ms:.4f} ms ({ms * 1e6 / steps:.1f} ns a step)"
                  for P, ms in row.items()), flush=True)
    return out


def ptxas_kernels(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in the build's ``-Xptxas -v`` output, demangled by
    c++filt where the machine has it."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


# The kernels of each split entry point and of K12, by a pattern of their
# demangled names.
SPLIT_KERNELS = {
    "ac_dense_count": r"dense_count_kernel<AcStreamLayout",
    "ac_sparse_count": r"ac_dense_count_kernel<AcWin",
    "ac_dense_states": r"dense_states_kernel",
    "ac_dense_states/seq": r"dense_seq_kernel",
    "ac_dense_count_many":
        r"ac_cols_kernel<AcBatchLayout[^(]*AcDenseTable<int, true>",
    "ac_dense_states_tm":
        r"ac_cols_kernel<AcBatchLayout[^(]*AcDenseTable<int, false>",
    "ac_dense_hits": r"hits_kernel<AcStreamLayout",
    "ac_window_hits": r"hits_kernel<AcWinLayout",
    "ac_stepped_count": r"stepped_lanes_kernel<[^(]*AcPackedTable",
    "ac_stepped_emit": r"stepped_emit_kernel",
    "ac_stepped_count_many": r"ac_cols_kernel<[^(]*AcPackedTable",
    "ac_stepped_count_2t": r"AcTwoTables",
    "ac_hybrid_count": r"hybrid_count_kernel",
    "ac_assoc_scan": r"assoc_\w+_kernel",
}


def registers_of(ptxas: list, entry: str):
    """The most registers and spill bytes over an entry point's kernels,
    or None for one that is not a stepped entry."""
    if entry not in SPLIT_KERNELS:
        return None
    rows = [r for r in ptxas if re.search(SPLIT_KERNELS[entry], r[0])]
    if not rows:
        return None
    return {"max": max(r[1] for r in rows),
            "spill_bytes": max(r[2] + r[3] for r in rows),
            "kernels": len(rows)}


def driven(build, entries, what: str, fn):
    """fn() with the launch counters set to 0 just before it and read just
    after; fails unless every kernel (or "entry/form") of ``entries`` was
    launched. Returns (fn's result, the launches and form launches)."""
    build.reset_launches()
    out = fn()
    launches = {**build.launches, **build.form_launches}
    print(f"launches in the {what} run: {launches}", flush=True)
    for entry in entries:
        check(launches.get(entry, 0) >= 1, f"{entry} ran in the {what} run")
    return out, launches


# The mesh paths' launches and times, printed as one JSON line at the end.
MESH_PATHS: dict = {}


def mesh_path(build, sc, entries, what: str, fn, dense=None,
              timed: bool = True):
    """fn() on the ShardedScanner sc with the launch counters and sc's
    per-shard tally set to 0 just before and read just after; fails unless
    every kernel (or "entry/form") of ``entries`` launched on every shard.
    Then, with ``timed``, fn() again on the wall clock beside ``dense()``,
    the DenseScanner doing the same; both end in a host result, so the
    device has finished. Returns fn()'s first result."""
    build.reset_launches()
    sc.shard_launches.clear()
    out = fn()
    torch.cuda.synchronize()
    tally = {i: dict(sc.shard_launches.get(i, {})) for i in range(sc.n_dev)}
    for i in range(sc.n_dev):
        for entry in entries:
            check(tally[i].get(entry, 0) >= 1,
                  f"{entry} ran on shard {i} in the mesh {what} run")
    totals = {e: v for e, v in {**build.launches,
                                **build.form_launches}.items() if v}
    ms = dense_ms = None
    if timed:
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        if dense is not None:
            t0 = time.perf_counter()
            dense()
            dense_ms = (time.perf_counter() - t0) * 1e3
    MESH_PATHS[what] = {"shards": sc.n_dev, "ms": ms, "dense_ms": dense_ms,
                        "launches": totals,
                        "per_shard": [tally[i] for i in range(sc.n_dev)]}
    print(f"mesh {what}: {sc.n_dev} shards, launches {totals}, per shard "
          f"{[sum(tally[i].values()) for i in range(sc.n_dev)]}; "
          f"{'' if ms is None else f'{ms:.1f} ms'}"
          f"{'' if dense_ms is None else f' (DenseScanner {dense_ms:.1f} ms)'}",
          flush=True)
    return out


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


def phase_batch_kernels(sc, docs, sc3, sc1, text: bytes) -> dict:
    """K5 and K6 against their plain versions at config 3's count_many
    shapes (its L bucket of 524,288 split into c blocks of Lp with the
    halo of 10), raw uint8 and int32 ids; K5 also on the slice's k = 3
    tables and K6 on its step_k=1 tables (sc1), each over 256 documents
    cut from the slice corpus; K5 and K6 also at every forced split."""
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
    k5 = functools.partial(multistep.stepped_count_many,
                           warm_steps=sc._warm_steps)
    args5 = (snap.packed, st.V, st.k, st.count_bits, sc._halo_steps, c, Lp)
    steps5 = sc._halo_steps + Lp // st.k
    k6 = functools.partial(scan_dense.dense_count_many,
                           warm_steps=sc._warm_syms)
    args6 = (snap.dflat, snap.nb_out, sc.V, sc.halo, c, Lp)
    res = {
        "ac_stepped_count_many": compare(
            "ac_stepped_count_many", k5, multistep.stepped_count_many_plain,
            args5, ins, shape + f" k=1 halo={sc._halo_sym}", need=needs(sc),
            steps=steps5),
        "ac_dense_count_many": compare(
            "ac_dense_count_many", k6, scan_dense.dense_count_many_plain,
            args6, ins, shape + f" halo={sc.halo}", need=needs(sc),
            steps=sc.halo + Lp)}
    for name, fn, plain, args, steps in (
            ("ac_stepped_count_many", k5, multistep.stepped_count_many_plain,
             args5, steps5),
            ("ac_dense_count_many", k6, scan_dense.dense_count_many_plain,
             args6, sc.halo + Lp)):
        for kind, row in split_sweep(name, fn, plain, args,
                                     {"raw_u8": ins["raw_u8"]},
                                     steps).items():
            res[name][kind]["ms_by_split"] = row
    st3, snap3 = sc3._stepped, sc3._snap
    L3 = min(len(text) // B, 1 << 18) // st3.k * st3.k
    tm3 = np.frombuffer(text[:B * L3], np.uint8).reshape(B, L3).T.copy()
    c3, Lp3 = sc3._split_for(L3, B, 128 * st3.k)
    k5_3 = functools.partial(multistep.stepped_count_many,
                             warm_steps=sc3._warm_steps)
    args3 = (snap3.packed, st3.V, st3.k, st3.count_bits, sc3._halo_steps, c3,
             Lp3)
    ins3 = {"slice_k3_raw_u8": (snap3.place(tm3),
                                snap3.place(sc3._get_lut("byte")[3]))}
    steps3 = sc3._halo_steps + Lp3 // st3.k
    k3 = compare("ac_stepped_count_many", k5_3,
                 multistep.stepped_count_many_plain, args3, ins3,
                 f"L={L3} B={B} c={c3} Lp={Lp3} k={st3.k} "
                 f"halo={sc3._halo_sym}", need=needs(sc3), steps=steps3)
    for kind, row in split_sweep("ac_stepped_count_many", k5_3,
                                 multistep.stepped_count_many_plain, args3,
                                 ins3, steps3).items():
        k3[kind]["ms_by_split"] = row
    res["ac_stepped_count_many"].update(k3)
    # K6 at the slice's step_k=1 batch: its tables fit on the SM
    snap1 = sc1._snap
    c1, Lp1 = sc1._split_for(L3, B, 128)
    k6_1 = functools.partial(scan_dense.dense_count_many,
                             warm_steps=sc1._warm_syms)
    args1 = (snap1.dflat, snap1.nb_out, sc1.V, sc1.halo if c1 > 1 else 0,
             c1, Lp1)
    ins1 = {"slice_k1_raw_u8": (snap1.place(tm3),
                                snap1.place(sc1._get_lut("byte")[3]))}
    steps1 = args1[3] + Lp1
    k6s = compare("ac_dense_count_many", k6_1,
                  scan_dense.dense_count_many_plain, args1, ins1,
                  f"L={L3} B={B} c={c1} Lp={Lp1} halo={args1[3]}",
                  need=needs(sc1), steps=steps1)
    for kind, row in split_sweep("ac_dense_count_many", k6_1,
                                 scan_dense.dense_count_many_plain, args1,
                                 ins1, steps1).items():
        k6s[kind]["ms_by_split"] = row
    res["ac_dense_count_many"].update(k6s)
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


def phase_count_many(build, m, docs, mesh) -> dict:
    """BASELINE config 3 through count_many: raw bytes (K5), the id path,
    a resident int32 [L, B] tensor, and a step_k=1 scanner (K6), each
    against the native host scan of every document; then the raw bytes on
    the mesh (K5 on every shard)."""
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
    stage_s, _ = best_s(lambda: batch_tm(docs, L, np.uint8), 1)
    parts = []
    for leg, (scanner, batch, _) in legs.items():
        t, _ = best_s(lambda: scanner.count_many(batch), 1)
        parts.append(f"{leg} {t * 1e3:.1f} ms = {mib / t:.1f} MiB/s")
    print(f"count_many config 3 ({CM_DOCS} x {CM_DOC_LEN} bytes, "
          f"{m.n_states} states, k={sc.step_k}, {int(oracle.sum())} "
          f"matches == host oracle, {oracle_s:.2f} s): {'; '.join(parts)}; "
          f"host column fill of the raw batch {stage_s * 1e3:.1f} ms",
          flush=True)
    from aho_corasick_1975_tpu_torch.parallel.sharded_scan import (
        ShardedScanner)
    shm = ShardedScanner(m, mesh, n_streams_per_device=MESH_STREAMS)
    got = mesh_path(build, shm, ("ac_stepped_count_many",), "count_many",
                    lambda: shm.count_many(docs),
                    lambda: sc.count_many(docs))
    check(np.array_equal(got, oracle), "mesh count_many equals the host "
          "oracle and DenseScanner per document")
    return launches


def session_chunks(text: bytes) -> list:
    """The corpus cut at seeded points into chunks of 1 byte to
    MAX_CHUNK."""
    rng = np.random.default_rng(3)
    cuts = [0]
    while cuts[-1] < len(text):
        size = int(np.exp(rng.uniform(0, np.log(MAX_CHUNK))))
        cuts.append(min(len(text), cuts[-1] + max(1, size)))
    return [text[a:b] for a, b in zip(cuts, cuts[1:])]


def phase_sessions(act, build, machine, sc, text: bytes, n: int,
                   ends: np.ndarray, count_s: float) -> None:
    """The slice corpus in seeded chunks of 1 byte to 12 MiB through
    feed_count and feed_matches, and a checkpoint resumed on a machine
    carried through save_machine/load_machine."""
    chunks = session_chunks(text)
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


def hunt_corpus() -> bytes:
    """benchmarks/bench_sparse_e2e.py's corpus: SPARSE_BYTES of 0x00 (OOV)
    with the keywords planted at SPARSE_DENSITY (default_rng(7))."""
    rng = np.random.default_rng(7)
    corpus = np.zeros(SPARSE_BYTES, np.uint8)
    n_plants = int(SPARSE_BYTES * SPARSE_DENSITY / 8)
    for start in rng.integers(0, SPARSE_BYTES - 16, n_plants):
        kw = SPARSE_KEYWORDS[int(start) % len(SPARSE_KEYWORDS)]
        corpus[start:start + len(kw)] = np.frombuffer(kw, np.uint8)
    return corpus.tobytes()


def resident_ids(density: float, n_live_ids: int) -> np.ndarray:
    """benchmarks/bench_sparse.py:build_corpus: RESIDENT_IDS int32 ids,
    OOV but for 8-symbol runs of letter ids at ``density``."""
    rng = np.random.default_rng(7)
    ids = np.zeros(RESIDENT_IDS, np.int32)
    starts = rng.integers(0, RESIDENT_IDS - 16,
                          int(RESIDENT_IDS * density / 8))
    pos = (starts[:, None] + np.arange(8)[None, :]).reshape(-1)
    ids[pos] = rng.integers(1, n_live_ids + 1, pos.shape[0]).astype(np.int32)
    return ids


def wall_ms(fn, runs: int):
    """(fn()'s wall milliseconds in each of ``runs`` runs after a warm-up
    run, each ended by a device synchronisation; the runs' results)."""
    fn()
    torch.cuda.synchronize()
    ms, outs = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def upload_floors(raw: np.ndarray, slot_bytes: int, depth: int) -> dict:
    """The three floors of an upload of ``raw`` (a writable uint8 array),
    each alone, wall ms of STAGING_RUNS runs: the pageable upload (what
    DeviceSnapshot.place does, a synchronous copy), the pinned upload
    (one non-blocking copy of a pinned copy of the bytes), and the host
    fill of the bytes into a ring of ``depth`` pinned slots of
    ``slot_bytes`` by the stager's own fill (``staging._fill``, torch's
    copy on its intra-op threads) and, beside it, by ``np.copyto``. The
    staging floor is the slower of the pinned upload and the stager's
    fill."""
    from aho_corasick_1975_tpu_torch.models import staging
    T = raw.size
    src = torch.from_numpy(raw)
    pinned = torch.empty(T, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(src)
    dev = torch.empty(T, dtype=torch.uint8, device="cuda")
    ring = [torch.empty(slot_bytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(depth)]
    ring_np = [r.numpy() for r in ring]
    pieces = [(i, a, min(slot_bytes, T - a))
              for i, a in enumerate(range(0, T, slot_bytes))]

    def fill(how):
        def run():
            for i, a, n in pieces:
                how(i % depth, a, n)
        return run

    runs = {
        "pageable_upload": lambda: src.to("cuda"),
        "pinned_upload": lambda: dev.copy_(pinned, non_blocking=True),
        "host_fill": fill(lambda j, a, n: staging._fill(ring[j][:n],
                                                        raw[a:a + n])),
        "host_fill_numpy": fill(lambda j, a, n: np.copyto(ring_np[j][:n],
                                                          raw[a:a + n])),
    }
    out = {}
    for k, fn in runs.items():
        ms, _ = wall_ms(fn, STAGING_RUNS)
        out[k] = {"best_ms": min(ms), "runs_ms": ms}
    out["staging_floor_ms"] = max(out["pinned_upload"]["best_ms"],
                                  out["host_fill"]["best_ms"])
    out["fill_threads"] = torch.get_num_threads()
    return out


def overlap_profile(build, fn) -> dict:
    """torch.profiler over one fn() (a pipelined count), the stager's host
    fill marked by a "stage_fill" annotation for the run: the device's busy
    share (the union of its kernel, copy and memset spans over the wall
    time, the profiler's cost in it) and the host-to-device copies of the
    copy stream (the stream of the copies that is not the kernels') that
    overlap a kernel span (any kernel, the pad's zeroing among them, and
    apart the scans': the kernels that are not PyTorch's own), a host
    fill begun after the copy was (the next chunk's), or host work begun
    during the copy."""
    from aho_corasick_1975_tpu_torch.models import staging
    from torch.profiler import ProfilerActivity, profile, record_function
    fill = staging._fill

    def marked(dst, src):
        with record_function("stage_fill"):
            fill(dst, src)

    torch.cuda.synchronize()
    staging._fill = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        staging._fill = fill
    path = os.path.join(build.BUILD_DIR, "staging_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def spans(cat, name="", but=None):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("args", {}).get("stream"))
                for e in events if e.get("cat") == cat
                and name in e.get("name", "")
                and (but is None or but not in e.get("name", ""))]

    kernels = spans("kernel")
    h2d = spans("gpu_memcpy", "HtoD")
    fills = spans("user_annotation", "stage_fill")
    device = sorted(kernels + h2d + spans("gpu_memcpy", "DtoH")
                    + spans("gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b, _ in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    k_streams = {st for _, _, st in kernels}
    copies = [c for c in h2d if c[2] not in k_streams]

    def overlaps(c, others):
        return any(a < c[1] and c[0] < b for a, b, _ in others)

    scans = spans("kernel", but="at::native")
    host_ops = spans("cpu_op")

    def next_fill(c):
        return [f for f in fills if f[0] > c[0]]

    with_kernel = sum(overlaps(c, kernels) for c in copies)
    with_scan = sum(overlaps(c, scans) for c in copies)
    with_fill = sum(overlaps(c, next_fill(c)) for c in copies)
    with_either = sum(overlaps(c, kernels) or overlaps(c, next_fill(c))
                      for c in copies)
    with_host = sum(any(c[0] < a < c[1] for a, _, _ in host_ops)
                    for c in copies)
    return {"result": got, "wall_ms": wall, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall,
            "kernels": len(kernels), "host_fills": len(fills),
            "copy_stream_h2d": len(copies),
            "h2d_ms": sum(b - a for a, b, _ in copies) / 1e3,
            "scan_kernels": len(scans),
            "h2d_overlapping_kernel": with_kernel,
            "h2d_overlapping_scan_kernel": with_scan,
            "h2d_overlapping_next_fill": with_fill,
            "h2d_overlapping_either": with_either,
            "h2d_overlapping_host_work": with_host}


def is_prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, int(n ** 0.5) + 1))


def phase_staging(act, build, machine, sc, sc1, text: bytes, n: int,
                  ranked) -> dict:
    """The staging ring (models/staging.py) on the slice: the upload
    floors of its bytes; count() from bytes, best of STAGING_RUNS, each
    run equal to the host oracle, beside the floors; the profile's
    evidence of overlap; the sweep of the pipeline's chunk and ring depth
    (and the count without the pipeline), exact at every point; a
    stale-slot case (a count of depth + 2 chunks of keywords, then one
    whose short last chunk lands in a slot that held keywords); the slice
    as a str through a machine of the same words as str keywords (int32
    code points through the pipeline) and a step_k=1 scanner's count
    (K1's raw form through it); find_matches() and the sessions' chunks.
    The main path's part runs with the launch counters set to 0 just
    before it and read just after."""
    raw = np.frombuffer(text, np.uint8).copy()
    C, depth = sc._pipeline_chunk, sc._pipeline_depth
    floors = upload_floors(raw, sc._stager.slot_bytes, depth)
    chunks = session_chunks(text)
    keywords = b"".join(ranked[:N_KEYWORDS])
    dense = (keywords * (((depth + 2) * C) // len(keywords) + 1))[
        :(depth + 1) * C + C // 2]
    short_len = 2 * C + C // 3
    while not is_prime(short_len):
        short_len += 1
    short = dense[:short_len]
    want = {name: machine.match_stream(machine.initiate(), t,
                                       parallel=False)
            for name, t in (("dense", dense), ("short", short))}
    as_str = text.decode()
    str_sc = keyword_machine(act, [w.decode() for w in ranked[:N_KEYWORDS]]
                             ).scanner(n_streams=N_STREAMS)

    def run():
        out = {"count": [sc.count(text) for _ in range(2)],
               "str": str_sc.count(as_str), "step_k1": sc1.count(text)}
        used = sc._stager.slots_used
        out["dense"] = sc.count(dense)
        out["short"] = sc.count(short)
        out["slots"] = sc._stager.slots_used - used
        t0 = time.perf_counter()
        out["find_matches"] = len(sc.find_matches(text))
        out["find_matches_ms"] = (time.perf_counter() - t0) * 1e3
        s = sc.session()
        t0 = time.perf_counter()
        for ch in chunks:
            s.feed_count(ch)
        out["sessions_ms"] = (time.perf_counter() - t0) * 1e3
        out["sessions"] = s.total
        return out

    got, launches = driven(build, ("ac_stepped_count", "ac_dense_count",
                                   "ac_stepped_emit"), "staging", run)
    check(got["count"] == [n, n] and got["str"] == n
          and got["step_k1"] == n, f"staged counts {got['count']}, str "
          f"{got['str']}, step_k=1 {got['step_k1']} equal {n}")
    check(got["dense"] == want["dense"] and got["short"] == want["short"],
          f"stale-slot case: {got['dense']}, {got['short']} equal the host "
          f"oracle {want['dense']}, {want['short']}")
    check(got["find_matches"] == n and got["sessions"] == n,
          f"find_matches {got['find_matches']}, sessions {got['sessions']}"
          f" equal {n}")

    runs, counts = wall_ms(lambda: sc.count(text), STAGING_RUNS)
    check(counts == [n] * STAGING_RUNS, f"count() runs {counts} equal {n}")
    best = min(runs)
    overlap = overlap_profile(build, lambda: sc.count(text))
    check(overlap.pop("result") == n, "the profiled count equals the oracle")
    check(overlap["h2d_overlapping_either"] >= 1, "a copy of the copy "
          "stream overlaps a kernel or the next chunk's host fill")
    pageable = floors["pageable_upload"]["best_ms"]
    check(best < pageable, f"count() from bytes {best:.2f} ms beats the "
          f"pageable upload alone of the same bytes {pageable:.2f} ms")

    sweep = []
    for c, d in [(c, d) for c in STAGING_CHUNKS for d in STAGING_DEPTHS] + [
            (None, depth)]:
        s = act.DenseScanner(machine, n_streams=N_STREAMS, snapshot=sc._snap)
        if c is None:   # no pipeline: one staged upload and one launch
            s._pipeline_min = len(text) + 1
        else:
            s._pipeline_chunk, s._pipeline_depth = c, d
        check(s.count(text) == n, f"sweep chunk {c} depth {d} (warm-up)")
        sweep.append({"chunk": c, "depth": d, "scanner": s, "runs_ms": []})
    # the points in turns, so that a slow spell of the host falls on all
    for _ in range(STAGING_ROUNDS):
        for point in sweep:
            t0 = time.perf_counter()
            got_n = point["scanner"].count(text)
            point["runs_ms"].append((time.perf_counter() - t0) * 1e3)
            check(got_n == n, f"sweep chunk {point['chunk']} depth "
                  f"{point['depth']}: {got_n} equals {n}")
    for point in sweep:
        del point["scanner"]
        point["best_ms"] = min(point["runs_ms"])
        point["median_ms"] = float(np.median(point["runs_ms"]))
        point["exact"] = True

    def feed_all():
        s = sc.session()
        for ch in chunks:
            s.feed_count(ch)
        return s.total

    find_ms, found = wall_ms(lambda: len(sc.find_matches(text)), 2)
    sess_ms, totals = wall_ms(feed_all, 2)
    check(found == totals == [n, n], f"timed find_matches {found} and "
          f"sessions {totals} equal {n}")
    res = {"bytes": len(text), "chunk": C, "depth": depth,
           "slot_bytes": sc._stager.slot_bytes, "floors": floors,
           "count": {"best_ms": best, "runs_ms": runs, "equal_oracle": True,
                     "share_of_staging_floor_rate":
                         floors["staging_floor_ms"] / best,
                     "faster_than_pageable_upload": best < pageable},
           "overlap": overlap, "sweep": sweep,
           "stale_slot": {"dense_bytes": len(dense), "dense": got["dense"],
                          "short_bytes": short_len, "short": got["short"],
                          "slots_taken": got["slots"],
                          "pad_zeroed_bytes": sc._stager.pad_zeroed,
                          "equal_oracle": True},
           "str": got["str"], "step_k1": got["step_k1"],
           "find_matches": {"matches": got["find_matches"],
                            "first_ms": got["find_matches_ms"],
                            "runs_ms": find_ms},
           "sessions": {"chunks": len(chunks), "total": got["sessions"],
                        "first_ms": got["sessions_ms"], "runs_ms": sess_ms},
           "launches": launches}
    print(f"staging: count() from bytes best {best:.2f} ms of "
          f"{', '.join(f'{t:.2f}' for t in runs)}; floors: pageable "
          f"{pageable:.2f}, pinned {floors['pinned_upload']['best_ms']:.2f},"
          f" host fill {floors['host_fill']['best_ms']:.2f} ms (numpy "
          f"{floors['host_fill_numpy']['best_ms']:.2f}); "
          f"{res['count']['share_of_staging_floor_rate']:.3f} of the staging"
          f" floor's rate; overlap {overlap}", flush=True)
    return res


def took(build, fn):
    """(fn()'s result, the kernels and K7/K8 input forms it launched, its
    wall seconds)."""
    before = {**build.launches, **build.form_launches}
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    after = {**build.launches, **build.form_launches}
    ran = [k for k, v in after.items() if v > before.get(k, 0)]
    return out, ",".join(sorted(ran)) or "no kernel", seconds


def device_busy(fn) -> str:
    """torch.profiler over one fn(): device busy ms (the self device time
    of the device's own events, the profiler table's "Self CUDA time
    total"), wall ms, idle share and the top device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                    for e in events[:5])
    return (f"device busy {busy:.2f} ms of {wall:.1f} ms wall (idle share "
            f"{1 - busy / wall:.3f}); top: {top}")


def host_profile(fn, n: int = 6) -> str:
    """cProfile over one fn(): the n functions with the most own time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:n]
    return "; ".join(
        f"{os.path.basename(f)}:{line} {name} {st[2] * 1e3:.1f} ms"
        for (f, line, name), st in top)


def phase_sparse(act, build):
    """(a) the signature hunt and (b) the resident ids, driven with the
    counters at 0: every K7 and K8 window form and both K2 modes must
    launch. Returns the scanners and inputs phase (d) reuses, and the
    launches."""
    from aho_corasick_1975_tpu_torch.ops import scan_dense
    t0 = time.perf_counter()
    m = act.Machine()
    for kw in SPARSE_KEYWORDS:
        m.insert_keyword(kw)
    text = hunt_corpus()
    sc = m.scanner(n_streams=4096, prefilter="on")
    sc1 = m.scanner(n_streams=4096, prefilter="on", step_k=1)   # K7 dense
    off = m.scanner(n_streams=4096)
    hunt_ids = sc._get_lut("byte")[3][np.frombuffer(text, np.uint8)]
    mr = act.Machine()
    for w in RESIDENT_WORDS:
        mr.insert_keyword(w)
    n_live_ids = len(set("".join(RESIDENT_WORDS)))
    scb = mr.scanner(n_streams=4096, prefilter="on")
    scb1 = mr.scanner(n_streams=4096, prefilter="on", step_k=1)
    corpora = {d: resident_ids(d, n_live_ids) for d in RESIDENT_DENSITIES}
    print(f"sparse set-up {time.perf_counter() - t0:.1f} s: hunt {len(text)} "
          f"bytes, {m.n_states} states, V={sc.V}, k={sc.step_k}, halo "
          f"{sc.halo}, geometry (k, halo, L_blk) {sc._sparse_geometry()}; "
          f"resident {RESIDENT_IDS} ids, {mr.n_states} states, V={scb.V}, "
          f"k={scb.step_k} {scb._sparse_geometry()}, step_k=1 "
          f"{scb1._sparse_geometry()}", flush=True)

    def run():
        hunt_t = torch.from_numpy(hunt_ids).to("cuda")
        hunt = {"count": took(build, lambda: sc.count(text)),
                "count stats": dict(sc.stats),
                "bounded": took(build, lambda: sc.find_matches(
                    text, max_hits=1 << 17)),
                "auto": took(build, lambda: sc.find_matches(text)),
                "tensor count": took(build, lambda: sc.count(hunt_t)),
                "tensor find": took(build, lambda: sc.find_matches(hunt_t)),
                "k1 count": took(build, lambda: sc1.count(text)),
                "k1 tensor count": took(build, lambda: sc1.count(hunt_t))}
        resident = {}
        for d, ids in corpora.items():
            tensor = torch.from_numpy(ids).to("cuda")
            for name, s in (("auto k", scb), ("step_k=1", scb1)):
                for kind, signs in (("host ids", ids), ("tensor", tensor)):
                    c = took(build, lambda: s.count(signs))
                    frac = s.stats["sparse_live_frac"]
                    f = took(build, lambda: s.find_matches(signs))
                    resident[d, name, kind] = (c, f, frac)
        seq_ids = corpora[1e-2][:SEQ_SYMBOLS]
        seq = (scb1.scan_states_sequential(seq_ids),
               scb1.scan_states(seq_ids))
        # K2 time-major has no caller in either scanner: its op, over a
        # [TM_SIDE, TM_SIDE] batch of the resident ids
        tm = torch.from_numpy(corpora[1e-2][:TM_SIDE ** 2]).to("cuda")
        states_tm = scan_dense.blocked_states(scb1._snap.dflat, scb1.V,
                                              tm.view(TM_SIDE, TM_SIDE),
                                              warm_steps=scb1._warm_syms)
        return hunt, resident, seq, states_tm.shape

    (hunt, resident, seq, tm_shape), launches = driven(
        build, ("ac_sparse_count", "ac_sparse_count_stepped",
                "ac_window_hits", "ac_dense_states/seq",
                "ac_dense_states_tm") + SPARSE_FORMS, "sparse", run)
    check(tm_shape == (TM_SIDE, TM_SIDE), "time-major K2 states shape")
    check(np.array_equal(*seq), "scan_states_sequential equals scan_states")

    # (a) the signature hunt
    t0 = time.perf_counter()
    oracle = m.match_stream(m.initiate(), text, parallel=False)
    oracle_s = time.perf_counter() - t0
    (n, path_c, count_s), (ms_b, path_b, bound_s), (ms, path_f, find_s) = (
        hunt["count"], hunt["bounded"], hunt["auto"])
    (n_t, path_tc, tcount_s), (ms_t, path_tf, tfind_s) = (
        hunt["tensor count"], hunt["tensor find"])
    (n1, path_1, k1_s), (n1_t, path_1t, k1t_s) = (hunt["k1 count"],
                                                  hunt["k1 tensor count"])
    n_off = off.count(text)
    with plain_ops("hits_extract"):   # the hunt's few live grams' refinement
        check(len(off.find_matches(text)) == n_off, "timed find_matches "
              "of the hunt, prefilter off")
    check(n == n_t == n1 == n1_t == oracle == n_off,
          f"sparse count {n} (tensor {n_t}; step_k=1 {n1}, tensor {n1_t}) "
          f"equals the host oracle {oracle} and prefilter=off {n_off}")
    check("ac_sparse_count/elided" in path_1.split(",")
          and "ac_sparse_count/idx" in path_1t.split(","),
          f"step_k=1 hunt counts ran K7 dense elided [{path_1}] and over "
          f"the index list [{path_1t}]")
    check(len(ms) == len(ms_b) == n and np.array_equal(ms.ends, ms_b.ends)
          and np.array_equal(ms.ends, ms_t.ends)
          and np.array_equal(ms.end_states, ms_t.end_states),
          "find_matches (auto, bounded, tensor) hold every match")
    idx = np.random.default_rng(2).choice(len(ms), min(1000, len(ms)),
                                          replace=False)
    for i in idx.tolist():
        kw = bytes(ms.match_for(int(ms.end_states[i])).letters)
        check(text[int(ms.starts[i]):int(ms.ends[i]) + 1] == kw,
              f"hunt match {i} spells its keyword")
    elided, frac = (hunt["count stats"]["sparse_elided_upload_bytes"],
                    hunt["count stats"]["sparse_live_frac"])
    hits_elided, hits_frac = (sc.stats["sparse_elided_upload_bytes"],
                              sc.stats["sparse_live_frac"])
    sparse_s, _ = best_s(lambda: sc.count(text))
    off_s, _ = best_s(lambda: off.count(text))
    bound_best, _ = best_s(lambda: sc.find_matches(text, max_hits=1 << 17)
                           .starts, 1)
    find_best, _ = best_s(lambda: sc.find_matches(text).starts, 1)
    raw = np.frombuffer(text, np.uint8).copy()

    def upload():
        torch.from_numpy(raw).to("cuda")
        torch.cuda.synchronize()
    upload_s, _ = best_s(upload, 2)
    mib = len(text) / 2 ** 20
    print(f"sparse (a) hunt: {n} matches == host oracle ({oracle_s:.2f} s) "
          f"== prefilter=off; count: live_frac {frac}, elided upload "
          f"{elided} bytes; retrieval (L_blk 128): live_frac {hits_frac}, "
          f"elided upload {hits_elided} bytes; count() [{path_c}] first "
          f"{count_s:.4f} s, best "
          f"{sparse_s:.4f} s = {mib / sparse_s:.1f} MiB/s; prefilter=off "
          f"count() {off_s:.4f} s = {mib / off_s:.1f} MiB/s; pageable upload "
          f"of the same bytes {upload_s:.4f} s = {mib / upload_s:.1f} MiB/s; "
          f"find_matches(max_hits=1<<17) [{path_b}] first {bound_s:.4f} s, "
          f"best {bound_best:.4f} s; find_matches() [{path_f}] first "
          f"{find_s:.4f} s, best {find_best:.4f} s; letter-id tensor: "
          f"count() [{path_tc}] {tcount_s:.4f} s, find_matches() "
          f"[{path_tf}] {tfind_s:.4f} s; step_k=1 count() [{path_1}] "
          f"{k1_s:.4f} s, tensor [{path_1t}] {k1t_s:.4f} s", flush=True)
    print(f"sparse (a) count() profile: {device_busy(lambda: sc.count(text))}",
          flush=True)
    print(f"sparse (a) count() host profile: "
          f"{host_profile(lambda: sc.count(text))}", flush=True)
    print(f"sparse (a) find_matches() host profile: "
          f"{host_profile(lambda: sc.find_matches(text))}", flush=True)
    print(f"sparse (a) prefilter=off count() profile: "
          f"{device_busy(lambda: off.count(text))}", flush=True)

    # (b) resident ids
    offb = mr.scanner(n_streams=4096)
    for d, ids in corpora.items():
        want = mr._b.match_bulk(0, ids)[1]
        tensor = torch.from_numpy(ids).to("cuda")
        dense_s, n_dense = best_s(lambda: offb.count(tensor))
        sparse_s, _ = best_s(lambda: scb.count(tensor))
        print(f"sparse (b) density {d} resident tensor count(): "
              f"prefilter=on {sparse_s * 1e3:.2f} ms, prefilter=off (K3 over "
              f"the whole stream) {dense_s * 1e3:.2f} ms", flush=True)
        ends0 = None
        for (dd, name, kind), ((c, pc, cs), (f, pf, fs), frac) in \
                resident.items():
            if dd != d:
                continue
            check(c == want == n_dense, f"{d} {name} {kind}: count {c} "
                  f"equals the host oracle {want} and prefilter=off "
                  f"{n_dense}")
            check(len(f) == c, f"{d} {name} {kind}: find_matches length")
            if ends0 is None:
                ends0 = f.ends
            check(np.array_equal(f.ends, ends0),
                  f"{d} {name} {kind}: match ends agree")
            print(f"sparse (b) density {d} {name} {kind}: {c} matches == "
                  f"host oracle, live_frac {frac:.5f}; count [{pc}] "
                  f"{cs * 1e3:.1f} ms; find_matches [{pf}] {fs * 1e3:.1f} ms",
                  flush=True)
    tensor = torch.from_numpy(corpora[1e-3]).to("cuda")
    with plain_ops("block_filter"):   # the device block filter
        check(scb.count(tensor) == mr._b.match_bulk(0, corpora[1e-3])[1],
              "timed prefilter count of a resident tensor")
    print(f"sparse (b) density 0.001 tensor count() profile: "
          f"{device_busy(lambda: scb.count(tensor))}", flush=True)
    return dict(sc=sc, text=text, hunt_ids=hunt_ids, mr=mr, scb=scb,
                scb1=scb1, corpora=corpora, tensor=tensor, hunt_n=n), launches


def phase_gate(build, machine, text: bytes, n: int, ends) -> dict:
    """(c) prefilter="auto" on the match-dense slice corpus declines:
    count() and find_matches() run K3 and K4, never K7 or K8's window
    form; a step_k=1 "auto" scanner's find_matches(max_hits) runs K8's
    stream form on raw bytes and on a letter-id tensor."""
    sca = machine.scanner(n_streams=N_STREAMS, prefilter="auto")
    sca1 = machine.scanner(n_streams=N_STREAMS, prefilter="auto", step_k=1)
    lut_host = sca1._get_lut("byte")[3]
    t_ids = torch.from_numpy(lut_host[np.frombuffer(text, np.uint8)]).to(
        "cuda")

    def run():
        return (took(build, lambda: sca.count(text)),
                took(build, lambda: sca.find_matches(text)),
                took(build, lambda: sca1.find_matches(text, max_hits=n)),
                took(build, lambda: sca1.find_matches(t_ids, max_hits=n)))

    (c, f, f1, f2), launches = driven(
        build, ("ac_stepped_count", "ac_stepped_emit", "ac_dense_hits"),
        "auto gate", run)
    for entry in ("ac_sparse_count", "ac_sparse_count_stepped",
                  "ac_window_hits"):
        check(launches[entry] == 0, f"{entry} did not run behind the gate")
    for form in ("ac_dense_hits/raw", "ac_dense_hits/ids"):
        check(build.form_launches.get(form, 0) >= 1, f"{form} ran")
    check(c[0] == n, f"auto-gate count {c[0]} equals {n}")
    for res in (f, f1, f2):
        check(np.array_equal(res[0].ends, ends), "auto-gate match ends")
    print(f"sparse (c) auto gate on the slice (live_frac "
          f"{sca.stats['sparse_live_frac']:.4f}): count [{c[1]}] "
          f"{c[2] * 1e3:.1f} ms; find_matches [{f[1]}] {f[2] * 1e3:.1f} ms; "
          f"step_k=1 find_matches(max_hits) raw [{f1[1]}] "
          f"{f1[2] * 1e3:.1f} ms, tensor [{f2[1]}] {f2[2] * 1e3:.1f} ms",
          flush=True)
    return dict(sca1=sca1, t_ids=t_ids, launches=launches)


def device_windows(s, tensor, halo: int, L_blk: int):
    """The live-block windows of a letter-id tensor on the card, as
    scanner ``s``'s device block filter gathers them: (ext, idx)."""
    ext, idx, _, _ = s._sparse_filter_device(tensor, None, halo, L_blk)
    return ext, idx


def elided_windows(s, arr: np.ndarray, lut, halo: int, L_blk: int):
    """The host-elided time-major windows [halo + L_blk, n] of ``arr``
    (letter ids, or bytes through ``lut``, (byte ids, byte live)) and their
    block ids, placed on scanner ``s``'s device."""
    from aho_corasick_1975_tpu_torch.ops import sparse
    if lut is None:
        live = sparse.live_blocks(arr, L_blk)
    else:
        live = sparse.raw_live_blocks(arr, lut[0], lut[1], L_blk)[0]
    tm, idx = sparse.elide_windows(arr, lut, len(arr), live, int(live.sum()),
                                   None, halo, L_blk, len(live))
    return s._snap.place(tm), s._snap.place(idx.astype(np.int32))


def planted_resident(machine, ids: np.ndarray) -> np.ndarray:
    """``ids`` (resident_ids) with the RESIDENT_WORDS of at most 8 letters,
    in turn, written over the start of every fourth run of letter ids: the
    live blocks stay those of ``ids`` (every run is at least 8 ids long),
    and its windows now hold matches (resident_ids' random letters hold
    none)."""
    out = ids.copy()
    live = out != 0
    starts = np.flatnonzero(live & ~np.concatenate(([False], live[:-1])))
    words = [np.array([machine.vocab.lookup(c) for c in w], np.int32)
             for w in RESIDENT_WORDS if len(w) <= 8]
    for i, start in enumerate(starts[::4]):
        w = words[i % len(words)]
        out[start:start + len(w)] = w
    return out


def hit_passes(build, fn, reps: int = 10) -> dict:
    """K8's two passes and what lies between them (the 8-byte sync of
    pass 1's totals, the cumsum of the offsets), timed apart: CUDA events
    around each of the wrapper's launches over ``reps`` calls of fn()
    after one warm-up; the mean ms of pass 1, of the gap from pass 1's end
    to pass 2's start, and of pass 2."""
    marks = []
    launch = build.launch

    def timed(name, dev, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch(name, dev, *a, **kw)
        e1.record()
        marks.append((e0, e1))

    build.launch = timed
    try:
        fn()
        sums = [0.0, 0.0, 0.0]
        for _ in range(reps):
            marks.clear()
            fn()
            torch.cuda.synchronize()
            check(len(marks) == 2, "K8 ran its two passes")
            (a0, a1), (b0, b1) = marks
            sums[0] += a0.elapsed_time(a1)
            sums[1] += a1.elapsed_time(b0)
            sums[2] += b0.elapsed_time(b1)
    finally:
        build.launch = launch
    return dict(zip(("pass1_ms", "between_ms", "pass2_ms"),
                    (x / reps for x in sums)))


# K7 dense's kernel in torch.profiler's names, the group naming it
K7_PATTERN = r"(ac_dense_count_kernel)<AcWin"


def k7_sweep(build, inputs: dict) -> dict:
    """K7 dense on each of ``inputs`` ({kind: (kernel, plain, args,
    extra)}): exact against its plain version at its launcher's pick (P 0
    below) and at every P of SPLIT_SWEEP, with the kernel's device ms at
    each (torch.profiler, mean of 20 calls): {kind: {"pick": P,
    "device_ms": {P: ms}}}."""
    out = {}
    for kind, (kernel, plain, args, extra) in inputs.items():
        want = plain(*args, *extra)
        row, pick = {}, None
        for P in (0,) + SPLIT_SWEEP:
            fn = functools.partial(kernel, *args, *extra, split=P)
            got = fn()
            torch.cuda.synchronize()
            check(max_abs_err(got, want) == 0,
                  f"K7 dense ({kind}) at split {P or 'pick'} equals its "
                  f"plain version")
            if P == 0:
                pick = build.splits["ac_sparse_count"]
            row[P] = sum(kernel_ms(fn, K7_PATTERN).values())
        out[kind] = {"pick": pick, "device_ms": row}
        print(f"kernel ac_sparse_count {kind}: pick P={pick}; device ms "
              f"(exact at each): "
              + ", ".join(f"{'pick' if P == 0 else f'P={P}'} {ms:.4f}"
                          for P, ms in row.items()), flush=True)
    return out


def enqueue_ms(fn, reps: int = 200) -> float:
    """Mean host ms a call of fn() takes to return, over reps calls after
    a warm-up, without a synchronisation between them (the card runs
    them behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def k7_call(build, kernel, args, extra, fields: dict) -> dict:
    """K7 dense's call at its pick split apart on the host: the wrapper's
    enqueue (``sparse.sparse_count``), build.launch's alone and the C
    entry point's alone (its plan, with the launchers' cached queries, and
    the launch), each its mean ms over calls without a sync."""
    lib = build.cuda_library()
    form = fields.pop("form")
    c_args = build.scan_args(**fields)
    stream = torch.cuda.current_stream().cuda_stream

    def entry():
        check(lib.ac_sparse_count(ctypes.byref(c_args), stream) == 0,
              "K7 dense's C entry point launches")
    return {"wrapper": enqueue_ms(lambda: kernel(*args, *extra)),
            "launch": enqueue_ms(lambda: build.launch(
                "ac_sparse_count", torch.device("cuda"), form, **fields)),
            "entry": enqueue_ms(entry)}


def phase_sparse_kernels(build, state: dict, gate: dict, text: bytes
                         ) -> dict:
    """(d) K7, K8 and the K2 modes against their plain versions at the
    sparse phase's shapes, exact; the kernel's mean over 10 runs. K7 dense
    also at every forced split, with device times (``k7_sweep``), and its
    call split into enqueue and device (``k7_call``), on the hunt's
    windows and on the resident 1e-3 ids with words planted, all holding
    matches. K8 and K2's time-major form also at every forced split (K8's
    stream form also with the tables through the read-only path), K8's
    passes timed apart, K2's one-thread form also through the read-only
    path."""
    from aho_corasick_1975_tpu_torch.ops import hits, scan_dense, sparse
    sc, scb, scb1 = state["sc"], state["scb"], state["scb1"]
    sca1, t_ids = gate["sca1"], gate["t_ids"]
    res = {}

    raw = np.frombuffer(state["text"], np.uint8)
    hunt_t = torch.from_numpy(state["hunt_ids"]).to("cuda")
    ent = sc._get_lut("byte")
    hunt_lut = (ent[3], ent[1])

    def stepped_args(s):
        k, _, L_blk = s._sparse_geometry()
        return (s._snap.packed, s._stepped.V, k, s._stepped.count_bits,
                s._halo_steps, L_blk)

    # K7 stepped: the hunt's k-gram windows hold its matches
    k, halo, L_blk = sc._sparse_geometry()
    hunt_tm, _ = elided_windows(sc, raw, hunt_lut, halo, L_blk)
    hunt_ext_k, hunt_idx_k = device_windows(sc, hunt_t, halo, L_blk)
    res["ac_sparse_count_stepped"] = compare(
        "ac_sparse_count_stepped", sparse.sparse_count_stepped,
        sparse.sparse_count_stepped_plain, stepped_args(sc),
        {"elided (a)": (hunt_tm, None),
         "idx (a) tensor": (hunt_ext_k, hunt_idx_k)},
        f"windows {tuple(hunt_tm.shape)}, cap={hunt_idx_k.numel()} k={k}",
        hits=True, need=needs(sc, halo, L_blk), steps=(halo + L_blk) // k)
    kb, halob, L_b = scb._sparse_geometry()
    ext_b, idx_b = device_windows(scb, state["tensor"], halob, L_b)
    res["ac_sparse_count_stepped"].update(compare(
        "ac_sparse_count_stepped", sparse.sparse_count_stepped,
        sparse.sparse_count_stepped_plain, stepped_args(scb),
        {"idx (b) 1e-3": (ext_b, idx_b)}, f"cap={idx_b.numel()} k={kb}",
        need=needs(scb, halob, L_b), steps=(halob + L_b) // kb))

    # K7 dense and K8 windows: the hunt's 1-char windows hold its matches
    hunt_hits_tm, hunt_hits_idx = elided_windows(sc, raw, hunt_lut, sc.halo,
                                                 128)
    hunt_ext, hunt_idx = device_windows(sc, hunt_t, sc.halo, 128)
    hunt_args = (sc._snap.dflat, sc._snap.nb_out, sc.V, sc.halo, 128)
    hunt_shape = (f"windows {tuple(hunt_hits_tm.shape)}, "
                  f"cap={hunt_idx.numel()}")
    k7 = functools.partial(sparse.sparse_count, **sc._dense_fields())
    k7_hunt = {"elided (a)": (hunt_hits_tm, None),
               "idx (a) tensor": (hunt_ext, hunt_idx)}
    res["ac_sparse_count"] = compare(
        "ac_sparse_count", k7, sparse.sparse_count_plain, hunt_args,
        k7_hunt, hunt_shape, hits=True, need=needs(sc, sc.halo, 128),
        steps=sc.halo + 128)
    snap1 = scb1._snap
    ext1, idx1 = device_windows(scb1, state["tensor"], scb1.halo, 128)
    tm1, tm1_idx = elided_windows(scb1, state["corpora"][1e-3], None,
                                  scb1.halo, 128)
    planted = planted_resident(state["mr"], state["corpora"][1e-3])
    ext1p, idx1p = device_windows(
        scb1, torch.from_numpy(planted).to("cuda"), scb1.halo, 128)
    tm1p, _ = elided_windows(scb1, planted, None, scb1.halo, 128)
    dense_args = (snap1.dflat, snap1.nb_out, scb1.V, scb1.halo, 128)
    k7b = functools.partial(sparse.sparse_count, **scb1._dense_fields())
    k7_res = {"idx (b) 1e-3 planted": (ext1p, idx1p),
              "elided (b) 1e-3 planted": (tm1p, None)}
    res["ac_sparse_count"].update(compare(
        "ac_sparse_count", k7b, sparse.sparse_count_plain, dense_args,
        k7_res, f"cap={idx1p.numel()} / windows {tuple(tm1p.shape)}",
        hits=True, need=needs(scb1, scb1.halo, 128), steps=scb1.halo + 128))
    swept = k7_sweep(build, {
        **{kind: (k7, sparse.sparse_count_plain, hunt_args, extra)
           for kind, extra in k7_hunt.items()},
        **{kind: (k7b, sparse.sparse_count_plain, dense_args, extra)
           for kind, extra in k7_res.items()}})
    out = torch.empty(hunt_hits_tm.shape[1], dtype=torch.int32,
                      device="cuda")
    call = k7_call(build, k7, hunt_args, k7_hunt["elided (a)"], dict(
        table=sc._snap.dflat, nb_out=sc._snap.nb_out, out=out, L=128,
        V=sc.V, halo=sc.halo,
        **sparse.window_fields(128, hunt_hits_tm, None),
        **scan_dense.dense_fields(sc._snap.dflat, sc.V, sc._warm_syms, 0,
                                  sc.tables.n_states, False)))
    for kind, row in res["ac_sparse_count"].items():
        row["device_ms"] = swept[kind]["device_ms"][0]
        row["ms_by_split"] = {P: ms for P, ms in
                              swept[kind]["device_ms"].items() if P}
    first_row = res["ac_sparse_count"]["elided (a)"]
    first_row["enqueue_ms"] = call
    print(f"kernel ac_sparse_count elided (a) call: device "
          f"{first_row['device_ms']:.4f} ms at P={first_row['split']}, "
          f"events {first_row['ms']:.4f} ms a call; enqueue "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in call.items()),
          flush=True)

    def hits_of(fn):
        def run(*a, **kw):
            pos, sts, n_hits, n_pos = fn(*a, **kw)
            return pos, sts, torch.tensor([n_hits, n_pos])
        return run

    def passes(entry, kernel, args, ins):
        for kind, extra in ins.items():
            res[entry][kind]["passes"] = row = hit_passes(
                build, lambda: kernel(*args, *extra))
            print(f"kernel {entry} {kind} passes: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()), flush=True)

    k8w = hits_of(functools.partial(hits.window_hits, **sc._dense_fields()))
    hunt_ins = {"elided (a)": (hunt_hits_tm, hunt_hits_idx),
                "idx (a) tensor": (hunt_ext, hunt_idx)}
    res["ac_window_hits"] = compare(
        "ac_window_hits", k8w, hits_of(hits.window_hits_plain), hunt_args,
        hunt_ins, hunt_shape, hits=True, need=needs(sc, sc.halo, 128),
        steps=sc.halo + 128)
    passes("ac_window_hits", k8w, hunt_args, hunt_ins)
    for kind, row in split_sweep(
            "ac_window_hits", k8w, hits_of(hits.window_hits_plain),
            hunt_args, hunt_ins, sc.halo + 128, reps=10).items():
        res["ac_window_hits"][kind]["ms_by_split"] = row
    k8w1 = hits_of(functools.partial(hits.window_hits,
                                     **scb1._dense_fields()))
    res["ac_window_hits"].update(compare(
        "ac_window_hits", k8w1, hits_of(hits.window_hits_plain), dense_args,
        {"idx (b) 1e-3": (ext1, idx1), "elided (b) 1e-3": (tm1, tm1_idx)},
        f"cap={idx1.numel()}", need=needs(scb1, scb1.halo, 128),
        steps=scb1.halo + 128))
    slice_raw = np.frombuffer(text, np.uint8)
    ext_raw, head_ids, B, L, T = sca1._stream_ext_raw(slice_raw, None,
                                                      sca1.halo, 128)
    ext_ids = sca1._ext_device(t_ids, None, sca1.halo, 128)[0]
    lut = sca1._get_lut("byte")[0]
    s1 = sca1._snap
    k8 = hits_of(functools.partial(hits.dense_hits, **sca1._dense_fields()))
    k8_args = (s1.dflat, s1.nb_out, sca1.V, sca1.halo, B, L)
    k8_ins = {"raw_u8": (ext_raw, lut, head_ids),
              "ids_i32": (ext_ids, None, None)}
    res["ac_dense_hits"] = compare(
        "ac_dense_hits", k8, hits_of(hits.dense_hits_plain), k8_args, k8_ins,
        f"B={B} L={L} (the slice, step_k=1)", hits=True, need=needs(sca1),
        steps=sca1.halo + L)
    passes("ac_dense_hits", k8, k8_args, k8_ins)
    for key, kw in (("ms_by_split", {}),
                    ("ms_by_split_read_only", dict(global_table=True))):
        for kind, row in split_sweep(
                "ac_dense_hits", k8, hits_of(hits.dense_hits_plain), k8_args,
                k8_ins, sca1.halo + L, reps=10, **kw).items():
            res["ac_dense_hits"][kind][key] = row
    # K2's one-thread form: one chain from the root, its tables on the SM
    # and through the read-only path
    seq_in = {"ids_i32": (t_ids[:SEQ_SYMBOLS].contiguous(),)}
    seq = []
    for kw in ({}, dict(global_table=True)):
        seq.append(compare("ac_dense_states/seq", functools.partial(
            scan_dense.sequential_states, n_states=sca1.tables.n_states,
            **kw), scan_dense.sequential_states_plain, (s1.dflat, sca1.V),
            seq_in, f"T={SEQ_SYMBOLS}{f' {kw}' if kw else ''}",
            need=needs(sca1), steps=SEQ_SYMBOLS))
        check(build.splits.get("ac_dense_states") == 1,
              "K2's one-thread form runs one chain")
    seq[0]["ids_i32"]["ms_read_only"] = seq[1]["ids_i32"]["ms"]
    res["ac_dense_states/seq"] = seq[0]
    tm = ext_ids[sca1.halo:].view(B, L).t().contiguous()
    k2tm = functools.partial(scan_dense.blocked_states,
                             warm_steps=sca1._warm_syms)
    tm_in = {"ids_i32": (tm,)}
    res["ac_dense_states_tm"] = compare(
        "ac_dense_states_tm", k2tm, scan_dense.blocked_states_plain,
        (s1.dflat, sca1.V), tm_in, f"[L, B] = [{L}, {B}]", need=needs(sca1),
        steps=L)
    for kind, row in split_sweep(
            "ac_dense_states_tm", k2tm, scan_dense.blocked_states_plain,
            (s1.dflat, sca1.V), tm_in, L, reps=10).items():
        res["ac_dense_states_tm"][kind]["ms_by_split"] = row
    return res


# -- the engines and the two-table count (K9-K11) ---------------------------


def forced_two_table():
    """Force the two-table k-gram form as tests/test_torch_unpacked.py
    does: the packed entry's width reads as too wide, so the snapshot
    composes the two tables on the card. Returns the function that undoes
    it."""
    from aho_corasick_1975_tpu_torch.ops import multistep
    orig_bits = multistep.packed_count_bits

    def undo():
        multistep.packed_count_bits = orig_bits

    multistep.packed_count_bits = lambda max_cnt, S: None
    return undo


def oracle_docs(m, docs) -> np.ndarray:
    return np.asarray([m.match_stream(m.initiate(), d, parallel=False)
                       for d in docs], np.int64)


def phase_two_table(act, build, ranked, text: bytes, n: int, t_ids,
                    docs):
    """The slice's dictionary with the two-table form forced: count() of
    the letter-id tensor (K9's stream form) and of the bytes (encoded on
    the host, as the reference's raw paths decline the two tables), and
    count_many of ``docs`` (K9's batch form), against the host oracle."""
    undo = forced_two_table()
    try:
        m = keyword_machine(act, ranked[:N_KEYWORDS])
        sc = m.scanner(n_streams=N_STREAMS)
    finally:
        undo()
    snap = sc._snap
    check(snap.packed is None and snap.delta_k is not None,
          "the slice's scanner holds the two-table form")

    def run():
        return (took(build, lambda: sc.count(t_ids)),
                took(build, lambda: sc.count(text)),
                took(build, lambda: sc.count_many(docs)))

    (ct, cb, cm), launches = driven(
        build, ("ac_stepped_count_2t/ids", "ac_stepped_count_2t/batch"),
        "two-table", run)
    check(ct[0] == cb[0] == n, f"two-table counts {ct[0]}, {cb[0]} equal "
          f"{n}")
    want = oracle_docs(m, docs)
    check(np.array_equal(cm[0], want) and want.sum() > 0,
          "two-table count_many equals the host oracle per document")
    print(f"two-table: k={sc.step_k}, delta_k and cnt_k "
          f"{nbytes((snap.delta_k, snap.cnt_k))} bytes; tensor count() "
          f"[{ct[1]}] {ct[2] * 1e3:.1f} ms, bytes count() [{cb[1]}] "
          f"{cb[2] * 1e3:.1f} ms, both {n} == host oracle; count_many of "
          f"{len(docs)} documents of {len(docs[0])} bytes [{cm[1]}] "
          f"{cm[2] * 1e3:.1f} ms, {int(want.sum())} matches == host oracle",
          flush=True)
    return dict(sc=sc, docs=docs), launches


def phase_hybrid(act, build, ranked, text: bytes, n: int, t_ids,
                 gather_s: float):
    """engine="hybrid" on the slice: count() of the bytes (pipelined, K11's
    raw form), of the letter-id tensor (its ids form), a session over the
    slice's chunks, then a refresh() of the next 10 words of bench.py's
    ranking and a count, each against the host oracle."""
    from aho_corasick_1975_tpu_torch.ops import scan_hybrid
    m = keyword_machine(act, ranked[:N_KEYWORDS])
    sc = m.scanner(n_streams=N_STREAMS, engine="hybrid")
    _, cbm, n_planes, S_pad = sc._hybrid
    B2 = scan_hybrid.mxu_cols(N_STREAMS, S_pad)
    print(f"hybrid: S_pad={S_pad}, n_planes={n_planes}, count_bits "
          f"{cbm}; at B={N_STREAMS} B1={N_STREAMS - B2} gather columns, "
          f"B2={B2} MMA columns", flush=True)
    chunks = session_chunks(text)
    extra = ranked[N_KEYWORDS:N_KEYWORDS + 10]

    def run():
        c = took(build, lambda: sc.count(text))
        ct = took(build, lambda: sc.count(t_ids))
        s = sc.session()
        t0 = time.perf_counter()
        total = sum(s.feed_count(ch) for ch in chunks)
        feed_s = time.perf_counter() - t0
        for w in extra:
            m.insert_keyword(w)
        status = sc.refresh()
        c2 = took(build, lambda: sc.count(text))
        return c, ct, total, feed_s, status, c2

    (c, ct, total, feed_s, status, c2), launches = driven(
        build, ("ac_hybrid_count/raw", "ac_hybrid_count/ids"), "hybrid",
        run)
    check(c[0] == ct[0] == total == n, f"hybrid counts {c[0]}, {ct[0]}, "
          f"session {total} equal {n}")
    oracle = m.match_stream(m.initiate(), text, parallel=False)
    check(c2[0] == oracle and sc._hybrid is not None,
          f"hybrid count after refresh {c2[0]} equals the host oracle "
          f"{oracle}")
    best, _ = best_s(lambda: sc.count(text))
    mib = len(text) / 2 ** 20
    print(f"hybrid: count() [{c[1]}] first {c[2] * 1e3:.1f} ms, best "
          f"{best * 1e3:.1f} ms = {mib / best:.1f} MiB/s (gather "
          f"{gather_s * 1e3:.1f} ms); tensor [{ct[1]}] {ct[2] * 1e3:.1f} ms;"
          f" session of {len(chunks)} chunks {feed_s * 1e3:.1f} ms, {total}"
          f" == {n}; refresh +10 returned {status}, {m.n_states} states, "
          f"count [{c2[1]}] {c2[0]} == host oracle", flush=True)
    return sc, launches


def mxu_prefix(act, ranked) -> int:
    """The largest N whose first N ranked keywords fit the MXU engine
    (S_pad <= MAX_MXU_STATES)."""
    from aho_corasick_1975_tpu_torch.ops import scan_mxu
    lo, hi = 1, len(ranked)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        t = keyword_machine(act, ranked[:mid]).compile()
        if scan_mxu.build_planes(t.delta, t.nb_outputs) is not None:
            lo = mid
        else:
            hi = mid - 1
    return lo


def phase_mxu(act, build, ranked, text: bytes, docs, hunt: bytes,
              hunt_n: int):
    """engine="mxu" with the largest prefix of bench.py's ranking that fits
    it: count() of the corpus from bytes (K10 raw) and as a tensor (ids),
    count_many of config 3's documents (batch), and the signature hunt
    with prefilter="on" from bytes (elided windows) and as a tensor (the
    index list), against the host oracle."""
    N = mxu_prefix(act, ranked)
    m = keyword_machine(act, ranked[:N])
    sc = m.scanner(n_streams=N_STREAMS, engine="mxu")
    _, cbits, n_planes, S_pad = sc._mxu
    t_ids = torch.from_numpy(sc._get_lut("byte")[3][
        np.frombuffer(text, np.uint8)]).to("cuda")
    mh = keyword_machine(act, SPARSE_KEYWORDS)
    sh = mh.scanner(n_streams=4096, prefilter="on", engine="mxu")
    h_ids = torch.from_numpy(sh._get_lut("byte")[3][
        np.frombuffer(hunt, np.uint8)]).to("cuda")
    print(f"mxu: N={N} words, {m.n_states} states, S_pad={S_pad}, V={sc.V},"
          f" n_planes={n_planes}, count_bits {cbits}; hunt {mh.n_states} "
          f"states, S_pad={sh._mxu[3]}", flush=True)

    def run():
        return (took(build, lambda: sc.count(text)),
                took(build, lambda: sc.count(t_ids)),
                took(build, lambda: sc.count_many(docs)),
                took(build, lambda: sh.count(hunt)),
                took(build, lambda: sh.count(h_ids)))

    (c, ct, cm, hb, ht), launches = driven(
        build, ("ac_mxu_count/raw", "ac_mxu_count/ids", "ac_mxu_count/batch",
                "ac_mxu_count/elided", "ac_mxu_count/idx"), "mxu", run)
    oracle = m.match_stream(m.initiate(), text, parallel=False)
    check(c[0] == ct[0] == oracle > 0, f"mxu counts {c[0]}, {ct[0]} equal "
          f"the host oracle {oracle}")
    want = oracle_docs(m, docs)
    check(np.array_equal(cm[0], want) and want.sum() > 0,
          "mxu count_many equals the host oracle per document")
    check(hb[0] == ht[0] == hunt_n, f"mxu hunt counts {hb[0]}, {ht[0]} "
          f"equal {hunt_n}")
    best, _ = best_s(lambda: sc.count(text))
    gather = m.scanner(n_streams=N_STREAMS)
    gbest, gn = best_s(lambda: gather.count(text))
    check(gn == oracle, "gather count of the MXU dictionary")
    mib = len(text) / 2 ** 20
    print(f"mxu: count() [{c[1]}] first {c[2] * 1e3:.1f} ms, best "
          f"{best * 1e3:.1f} ms = {mib / best:.1f} MiB/s, gather (k="
          f"{gather.step_k}) {gbest * 1e3:.1f} ms; {oracle} matches == host "
          f"oracle; tensor [{ct[1]}] {ct[2] * 1e3:.1f} ms; count_many "
          f"[{cm[1]}] {cm[2] * 1e3:.1f} ms, {int(want.sum())} matches == "
          f"host oracle; hunt bytes [{hb[1]}] {hb[2] * 1e3:.1f} ms, tensor "
          f"[{ht[1]}] {ht[2] * 1e3:.1f} ms, {hunt_n} matches", flush=True)
    return dict(sc=sc, sh=sh, t_ids=t_ids, h_ids=h_ids, N=N,
                hunt=hunt, oracle=oracle), launches


def phase_calibration(act, ranked, n_mxu: int) -> None:
    """calibrate=True on the slice's and the MXU dictionary's scanners: the
    probe times each engine that fits; a second scanner of the same
    geometry takes the cached choice without probing."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    os.environ["ACX_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    try:
        for label, words in (("slice", ranked[:N_KEYWORDS]),
                             ("mxu", ranked[:n_mxu])):
            m = keyword_machine(act, words)
            t0 = time.perf_counter()
            sc = m.scanner(n_streams=N_STREAMS, calibrate=True)
            probe_s = time.perf_counter() - t0
            check("calibration" in sc.stats, f"{label}: the probe ran")
            sc2 = m.scanner(n_streams=N_STREAMS, calibrate=True)
            check("calibration" not in sc2.stats
                  and sc2._engine == sc._engine,
                  f"{label}: a second scanner takes the cached choice")
            print(f"calibration {label}: {m.n_states} states, stats "
                  f"{sc.stats['calibration']} (s), winner {sc._engine}, "
                  f"scanner with probe {probe_s:.2f} s; second scanner "
                  f"{sc2._engine}, no probe", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_engine_kernels(two: dict, hyb, mxu: dict, text: bytes, docs,
                         kern: dict) -> dict:
    """K9, K10 and K11 against their plain versions, each form, at the
    slice's kernel shapes (K9's batch form over shorter documents, which
    its plain version's per-step loop allows)."""
    from aho_corasick_1975_tpu_torch.ops import (build, multistep,
                                                 scan_hybrid, scan_mxu,
                                                 sparse)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    B, L = N_STREAMS, KERNEL_L
    sc2 = two["sc"]
    docs2 = [d[:TWO_TABLE_DOC] for d in two["docs"]]
    st, snap = sc2._stepped, sc2._snap
    args9 = (snap.delta_k, snap.cnt_k, st.V, st.k, sc2._halo_steps, B, L)
    k9 = functools.partial(multistep.stepped_count_2t,
                           warm_steps=sc2._warm_steps)
    ins9 = stream_inputs(sc2, text, sc2._halo_sym, B, L)
    steps9 = sc2._halo_steps + L // st.k
    res["ac_stepped_count_2t"] = compare(
        "ac_stepped_count_2t", k9, multistep.stepped_count_2t_plain, args9,
        ins9, f"B={B} L={L} k={st.k}", hits=True, need=needs(sc2),
        steps=steps9)
    Lb = next(sc2._length_buckets(np.array([len(docs2[0])]), 128 * st.k))[0]
    tm9 = snap.place(batch_tm(docs2, Lb, np.int32, sc2.encode))
    k9b = functools.partial(multistep.stepped_count_many_2t,
                            warm_steps=sc2._warm_steps)
    args9b = (snap.delta_k, snap.cnt_k, st.V, st.k)
    res["ac_stepped_count_2t"].update(compare(
        "ac_stepped_count_2t", k9b, multistep.stepped_count_many_2t_plain,
        args9b, {"batch": (tm9,)}, f"[L, B] = [{Lb}, {len(docs2)}]",
        hits=True, need=needs(sc2), steps=Lb // st.k))
    sweeps = {**split_sweep("ac_stepped_count_2t", k9,
                            multistep.stepped_count_2t_plain, args9, ins9,
                            steps9),
              **split_sweep("ac_stepped_count_2t", k9b,
                            multistep.stepped_count_many_2t_plain, args9b,
                            {"batch": (tm9,)}, Lb // st.k)}
    for kind, row in sweeps.items():
        res["ac_stepped_count_2t"][kind]["ms_by_split"] = row

    scm, sh = mxu["sc"], mxu["sh"]
    planes, cbits, n_planes, _ = scm._mxu
    k10 = functools.partial(scan_mxu.mxu_count, planes_t=scm._planes_t)
    Lm = scm._layout(len(text), 128)[1]
    args10 = (planes, scm.V, cbits, n_planes, scm.halo, B, Lm)
    ins10 = stream_inputs(scm, text, scm.halo, B, Lm)
    res["ac_mxu_count"] = compare(
        "ac_mxu_count", k10, scan_mxu.mxu_count_plain, args10, ins10,
        f"B={B} L={Lm}", hits=True,
        ops=lambda *e: mma_ops(B, scm.halo + Lm), steps=scm.halo + Lm)
    Lc = next(scm._length_buckets(np.array([CM_DOC_LEN]), 128))[0]
    c, Lp = scm._split_for(Lc, len(docs), 128)
    lut = scm._snap.place(scm._get_lut("byte")[3])
    res["ac_mxu_count"].update(compare(
        "ac_mxu_count", functools.partial(scan_mxu.mxu_count_many,
                                          planes_t=scm._planes_t),
        scan_mxu.mxu_count_many_plain,
        (planes, scm.V, cbits, n_planes, scm.halo, c, Lp),
        {"batch raw_u8": (scm._snap.place(batch_tm(docs, Lc, np.uint8)),
                          lut)},
        f"L={Lc} B={len(docs)} c={c} Lp={Lp}", hits=True,
        ops=lambda *e: mma_ops(c * len(docs), scm.halo + Lp),
        steps=scm.halo + Lp))
    hp, hcb, hnp, _ = sh._mxu
    ent = sh._get_lut("byte")
    raw = np.frombuffer(mxu["hunt"], np.uint8)
    live = sparse.raw_live_blocks(raw, ent[3], ent[1], 128)[0]
    win, _ = sparse.elide_windows(raw, (ent[3], ent[1]), len(raw), live,
                                  int(live.sum()), None, sh.halo, 128,
                                  len(live))
    ext, idx, _, _ = sh._sparse_filter_device(mxu["h_ids"], None, sh.halo,
                                              128)
    res["ac_mxu_count"].update(compare(
        "ac_mxu_count", functools.partial(sparse.sparse_count_mxu,
                                          planes_t=sh._planes_t),
        sparse.sparse_count_mxu_plain,
        (hp, sh.V, hcb, hnp, sh.halo, 128),
        {"elided (hunt)": (sh._snap.place(win), None),
         "idx (hunt tensor)": (ext, idx)},
        f"hunt windows {tuple(win.shape)}, cap={idx.numel()}", hits=True,
        need=needs(sh, sh.halo, 128),
        ops=lambda src, i: mma_ops(
            src.shape[1] if i is None else i.numel(), sh.halo + 128)))

    sth = hyb._stepped
    hplanes, cbm, hn, S_pad = hyb._hybrid
    B2 = scan_hybrid.mxu_cols(B, S_pad)
    k11 = functools.partial(scan_hybrid.hybrid_count, planes_t=hyb._planes_t,
                            warm_steps=hyb._warm_steps)
    args11 = (hyb._snap.packed, hplanes, sth.V, sth.k, sth.count_bits,
              hyb._halo_steps, hn, cbm, B - B2, B, L)
    # count()'s layout pads the corpus to B*L, and the padding is the last
    # columns, the MMA half's; the corpus repeated to fill every column
    # gives that half text, and its own matches
    ins11 = stream_inputs(hyb, text, hyb._halo_sym, B, L)
    full11 = stream_inputs(hyb, text, hyb._halo_sym, B, L, fill=True)
    fill11 = {f"{kind} (text in every column)": v
              for kind, v in full11.items()}
    shape11 = f"B={B} (B1={B - B2}, B2={B2}) L={L} k={sth.k}"
    ops11 = lambda *e: mma_ops(B2, hyb._halo_sym + L)
    grams11 = hyb._halo_steps + L // sth.k
    res["ac_hybrid_count"] = compare(
        "ac_hybrid_count", k11, scan_hybrid.hybrid_count_plain, args11,
        ins11, shape11, hits=True, need=needs(hyb), ops=ops11,
        steps=grams11)
    res["ac_hybrid_count"].update(compare(
        "ac_hybrid_count", k11, scan_hybrid.hybrid_count_plain, args11,
        fill11, shape11, hits=slice(B - B2, None), need=needs(hyb),
        ops=ops11, steps=grams11))
    for kind, row in split_sweep("ac_hybrid_count", k11,
                                 scan_hybrid.hybrid_count_plain, args11,
                                 fill11, grams11).items():
        res["ac_hybrid_count"][kind]["ms_by_split"] = row
    # K11 beside its two halves alone: the MMA half as K11's launch with
    # no gather column (B1 = 0) over the B2 MMA columns, the gather half as
    # K3's over the B1 gather columns, each equal to K11's own columns
    k3h = functools.partial(multistep.stepped_count,
                            warm_steps=hyb._warm_steps)
    args_m = (hyb._snap.packed, hplanes, sth.V, sth.k, sth.count_bits,
              hyb._halo_steps, hn, cbm, 0, B2, L)
    args_g = (hyb._snap.packed, sth.V, sth.k, sth.count_bits,
              hyb._halo_steps, B - B2, L)
    for kind, (ext, lut, head) in full11.items():
        whole = k11(*args11, ext, lut, head)
        mma_ext = ext[(B - B2) * L:]
        # its first column's halo rows, through the LUT, as head ids
        mma_in = (mma_ext, lut, None if lut is None else
                  lut[mma_ext[:hyb._halo_sym].long()].to(torch.int32))
        check(torch.equal(k11(*args_m, *mma_in), whole[B - B2:]) and
              torch.equal(k3h(*args_g, ext[:hyb._halo_sym + (B - B2) * L],
                              lut, head), whole[:B - B2]),
              f"K11's halves alone ({kind}) equal its own columns")
        ms11 = res["ac_hybrid_count"][f"{kind} (text in every column)"]["ms"]
        ms_m = cuda_ms(lambda: k11(*args_m, *mma_in), 10)
        ms_g = cuda_ms(lambda: k3h(
            *args_g, ext[:hyb._halo_sym + (B - B2) * L], lut, head), 10)
        res["ac_hybrid_count"][f"{kind} (text in every column)"].update(
            mma_half_ms=ms_m, gather_half_ms=ms_g)
        print(f"K11 {kind} (text in every column) {ms11:.4f} ms beside its "
              f"MMA half alone {ms_m:.4f} ms (K11 over its {B2} MMA "
              f"columns, B1 = 0) and its gather half alone {ms_g:.4f} ms (K3 "
              f"over the {B - B2} gather columns at P="
              f"{build.splits.get('ac_stepped_count')}), B={B} L={L}",
              flush=True)
    steps11 = hyb._halo_sym + L
    for kind in ("raw_u8", "ids_i32", "raw_u8 (text in every column)",
                 "ids_i32 (text in every column)"):
        ms11 = res["ac_hybrid_count"][kind]["ms"]
        ms3 = kern["ac_stepped_count"][kind.split()[0]]["ms"]
        print(f"K11 {kind} {ms11:.4f} ms ({ms11 * 1e6 / steps11:.1f} ns a "
              f"symbol step) beside K3 "
              f"{ms3:.4f} ms ({ms3 * 1e6 * sth.k / steps11:.1f} ns a gram "
              f"step) at B={B} L={L} (the slice's tables)", flush=True)
    # K10 beside K3 on the MXU dictionary's own tables
    stm = scm._stepped
    L3 = Lm // stm.k * stm.k
    ins3 = stream_inputs(scm, text, scm._halo_sym, B, L3)
    for kind, extra in ins3.items():
        ms3 = cuda_ms(lambda: multistep.stepped_count(
            scm._snap.packed, stm.V, stm.k, stm.count_bits, scm._halo_steps,
            B, L3, *extra, warm_steps=scm._warm_steps), 10)
        ms10 = res["ac_mxu_count"][kind]["ms"]
        print(f"K10 {kind} {ms10:.4f} ms ({ms10 * 1e6 / (scm.halo + Lm):.1f}"
              f" ns a symbol step) beside K3 "
              f"{ms3:.4f} ms ({ms3 * 1e6 / (scm._halo_steps + L3 // stm.k):.1f}"
              f" ns a gram step, k={stm.k}) at B={B} L={L3} (the MXU "
              f"dictionary's tables)", flush=True)
    return res


def phase_mesh(act, build, mesh, machine, sc, sc1, text: bytes, n: int,
               ms, t_ids, ranked, mxu: dict, state: dict) -> None:
    """The mesh path: the slice's dictionary and corpus on MESH_SHARDS
    logical shards of cuda:0, n_streams_per_device=MESH_STREAMS, each
    path's kernels on every shard, each result against the host oracle
    (n, the hunt's and MXU dictionary's counts, checked against it in
    earlier phases) and the DenseScanner; then one count through a
    one-rank NCCL group, and a mesh of every card where there are more."""
    from aho_corasick_1975_tpu_torch.parallel import mesh as pmesh
    from aho_corasick_1975_tpu_torch.parallel.sharded_scan import (
        ShardedScanner)
    import torch.distributed as dist

    def scanner(m, **kw):
        return ShardedScanner(m, mesh, n_streams_per_device=MESH_STREAMS,
                              **kw)

    t0 = time.perf_counter()
    sh = scanner(machine)
    sh1 = scanner(machine, step_k=1)
    pad = -t_ids.numel() % MESH_SHARDS
    placed = pmesh.data_sharded(mesh, torch.cat([t_ids, torch.zeros(
        pad, dtype=t_ids.dtype, device=t_ids.device)]))
    print(f"mesh: {mesh}, k={sh.step_k}, halo {sh.halo}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def same(a, b) -> bool:
        return (np.array_equal(a.ends, b.ends)
                and np.array_equal(a.end_states, b.end_states)
                and np.array_equal(a.indices, b.indices))

    K3, K4 = ("ac_stepped_count",), ("ac_stepped_emit",)
    check(mesh_path(build, sh, K3, "count bytes", lambda: sh.count(text),
                    lambda: sc.count(text)) == n, "mesh count of the bytes")
    check(mesh_path(build, sh, K3, "count tensor", lambda: sh.count(placed),
                    lambda: sc.count(t_ids)) == n, "mesh count of a tensor")
    check(same(mesh_path(build, sh, K4, "find_matches auto",
                         lambda: sh.find_matches(text),
                         lambda: sc.find_matches(text)), ms),
          "mesh find_matches equals DenseScanner's")
    check(same(mesh_path(build, sh, K4, "find_matches bounded",
                         lambda: sh.find_matches(text, max_hits_per_shard=n),
                         lambda: sc.find_matches(text, max_hits=n)), ms),
          "mesh bounded find_matches equals DenseScanner's")
    check(mesh_path(build, sh1, ("ac_dense_count",), "step_k=1 count",
                    lambda: sh1.count(text), lambda: sc1.count(text)) == n,
          "mesh step_k=1 count")
    check(np.array_equal(mesh_path(
        build, sh1, ("ac_dense_hits",), "step_k=1 find_matches bounded",
        lambda: sh1.find_matches(text, max_hits_per_shard=n),
        lambda: sc1.find_matches(text, max_hits=n)).ends, ms.ends),
        "mesh step_k=1 bounded find_matches' ends")
    prefix = text[:4 << 20]
    check(np.array_equal(mesh_path(
        build, sh1, ("ac_dense_states",), "step_k=1 scan_states 4 MiB",
        lambda: sh1.scan_states(prefix), lambda: sc1.scan_states(prefix)),
        sc1.scan_states(prefix)), "mesh scan_states equals DenseScanner's")

    chunks = session_chunks(text)
    half = len(chunks) // 2

    def session_run(scanner):
        s = scanner.session()
        for ch in chunks[:half]:
            s.feed_count(ch)
        s = act.StreamSession.restore(scanner, s.checkpoint())
        for ch in chunks[half:]:
            s.feed_count(ch)
        return s.total
    check(mesh_path(build, sh, K3, f"session of {len(chunks)} chunks",
                    lambda: session_run(sh), lambda: session_run(sc)) == n,
          "mesh session total, resumed from a checkpoint at half")

    mr = keyword_machine(act, ranked[:N_KEYWORDS])
    shr = scanner(mr)
    dr = mr.scanner(n_streams=N_STREAMS)
    for w in ranked[N_KEYWORDS:N_KEYWORDS + 10]:
        mr.insert_keyword(w)
    refresh_ms = {}

    def refresh_run():
        t0 = time.perf_counter()
        status = shr.refresh()
        refresh_ms["mesh"] = (time.perf_counter() - t0) * 1e3
        return status, shr.count(text)
    status, c = mesh_path(build, shr, K3, "refresh +10 and count",
                          refresh_run, timed=False)
    t0 = time.perf_counter()
    dr.refresh()
    refresh_ms["dense"] = (time.perf_counter() - t0) * 1e3
    oracle = mr.match_stream(mr.initiate(), text)
    check(c == oracle == dr.count(text),
          f"mesh count after refresh {c} equals the host oracle {oracle} "
          f"and a DenseScanner's")
    MESH_PATHS["refresh +10 and count"].update(
        ms=refresh_ms["mesh"], dense_ms=refresh_ms["dense"])
    print(f"mesh refresh +10: returned {status} in "
          f"{refresh_ms['mesh']:.1f} ms (DenseScanner {refresh_ms['dense']:.1f}"
          f" ms), count {c} == host oracle", flush=True)

    shh = scanner(machine, engine="hybrid")
    dh = machine.scanner(n_streams=N_STREAMS, engine="hybrid")
    check(mesh_path(build, shh, ("ac_hybrid_count/raw",), "hybrid count",
                    lambda: shh.count(text), lambda: dh.count(text)) == n,
          "mesh hybrid count")
    scm = mxu["sc"]
    shx = scanner(scm.machine, engine="mxu")
    check(mesh_path(build, shx, ("ac_mxu_count/raw",), "mxu count",
                    lambda: shx.count(text), lambda: scm.count(text))
          == mxu["oracle"], "mesh MXU count equals the host oracle")

    hunt, hunt_n, dsp = state["text"], state["hunt_n"], state["sc"]
    shp = scanner(dsp.machine, prefilter="on")
    h_placed = pmesh.data_sharded(mesh, state["hunt_ids"])
    h_tensor = torch.from_numpy(state["hunt_ids"]).to("cuda")
    check(mesh_path(build, shp, ("ac_sparse_count_stepped/elided",),
                    "hunt count bytes", lambda: shp.count(hunt),
                    lambda: dsp.count(hunt)) == hunt_n,
          "mesh hunt count (raw elision)")
    check(len(mesh_path(build, shp, ("ac_window_hits/elided",),
                        "hunt find_matches bytes",
                        lambda: shp.find_matches(hunt),
                        lambda: dsp.find_matches(hunt))) == hunt_n,
          "mesh hunt find_matches (elided windows)")
    check(mesh_path(build, shp, ("ac_sparse_count/idx",),
                    "hunt count tensor", lambda: shp.count(h_placed),
                    lambda: dsp.count(h_tensor)) == hunt_n,
          "mesh hunt count of a tensor (device block filter)")
    del h_placed, h_tensor

    from socket import socket
    with socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pmesh.init_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=1, process_id=0)
    try:
        check(dist.get_backend() == "nccl", "the process group is NCCL")
        mesh_nccl = pmesh.make_mesh(devices=["cuda:0"] * MESH_SHARDS)
        check(mesh_nccl.distributed, "the mesh spans the process group")
        shn = ShardedScanner(machine, mesh_nccl,
                             n_streams_per_device=MESH_STREAMS)
        check(mesh_path(build, shn, K3, "count through NCCL",
                        lambda: shn.count(text)) == n,
              "mesh count through a one-rank NCCL group")
    finally:
        dist.destroy_process_group()
    if torch.cuda.device_count() > 1:
        sha = ShardedScanner(machine, pmesh.make_mesh(),
                             n_streams_per_device=MESH_STREAMS)
        check(mesh_path(build, sha, K3, "count on every card",
                        lambda: sha.count(text)) == n,
              "mesh count on every card")


def kernel_ms(fn, pattern: str, reps: int = 20) -> dict:
    """Mean device ms a call of fn() spends in each CUDA kernel whose name
    matches ``pattern`` (its first group names it), by torch.profiler over
    reps calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.device_type == DeviceType.CUDA:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + e.self_device_time_total / 1e3 / reps)
    return out


def lookup_bound_ms(lookups: int) -> float:
    """The least time for ``lookups`` table lookups from shared memory:
    32 a clock on each SM (one 4-byte word a bank), at the card's
    maximum SM clock (nvidia-smi clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lookups / (sms * 32 * mhz * 1e6) * 1e3


def phase_assoc(act, build, sc, text: bytes) -> dict:
    """K12 through make_assoc_scan (the user's entry point, counted) on
    ASSOC_T symbols of a tests/test_assoc_scan.py-style dictionary, then
    against its plain version and K2's one-thread form, exact, with its
    three phases timed apart on the device (torch.profiler: ``phases``,
    their sum ``device_ms``, beside ``ms``, the call's) and its bound in
    lookups beside its bound in bytes; then on the slice's dictionary (3,919
    states: the tiles' functions past what a block stages, read in place)
    over the corpus's first ASSOC_SLICE_T bytes against K2's one-thread
    form."""
    from aho_corasick_1975_tpu_torch.ops import scan_assoc, scan_dense
    rng = np.random.default_rng(1)
    act_m = act.Machine()
    for _ in range(25):
        act_m.insert_keyword("".join(rng.choice(list("ab"),
                                                rng.integers(1, 6))))
    t = act_m.compile()
    S, V = t.n_states, t.vocab_size
    delta = torch.from_numpy(np.ascontiguousarray(t.delta, np.int32)).cuda()
    ids = torch.from_numpy(np.asarray(act_m.vocab.lookup_many(
        "".join(rng.choice(list("abx"), ASSOC_T))), np.int32)).cuda()
    got, launches = driven(build, ("ac_assoc_scan",), "associative scan",
                           lambda: scan_assoc.make_assoc_scan(V)(delta, ids))
    n_chunks = -(-ASSOC_T // scan_assoc.CHUNK)
    res = compare("ac_assoc_scan", scan_assoc.assoc_scan,
                  scan_assoc.assoc_scan_plain, (delta,), {"ids": (ids,)},
                  f"T={ASSOC_T} S={S} V={V} chunk={scan_assoc.CHUNK} "
                  f"tile={scan_assoc.tile_for(n_chunks)}")
    seq = scan_dense.sequential_states(delta.reshape(-1), V, ids)
    check(torch.equal(got, seq), "K12 equals K2's one-thread form")
    seq_ms = cuda_ms(lambda: scan_dense.sequential_states(
        delta.reshape(-1), V, ids), 2)
    phases = kernel_ms(lambda: scan_assoc.assoc_scan(delta, ids),
                       r"assoc_(\w+)_kernel")
    check(set(phases) == {"compose", "tiles", "states"},
          f"K12's three phases were timed ({sorted(phases)})")
    lookups = ASSOC_T * S
    row = res["ids"]
    row.update(phases=phases, device_ms=sum(phases.values()), seq_ms=seq_ms,
               lookup_bound_ms=lookup_bound_ms(lookups))
    print(f"K12 at T={ASSOC_T}: {row['ms']:.4f} ms a call, "
          f"{row['device_ms']:.4f} ms on the device: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in phases.items())
          + f"; K2's one thread {seq_ms:.3f} ms; bound {row['bound_ms']:.4f}"
          f" ms in bytes, {row['lookup_bound_ms']:.4f} ms in its {lookups} "
          f"lookups (T*S by design; K2 does T)", flush=True)
    d_slice = torch.from_numpy(np.ascontiguousarray(sc.tables.delta,
                                                    np.int32)).cuda()
    ids_slice = torch.from_numpy(np.ascontiguousarray(
        sc.encode(text[:ASSOC_SLICE_T]), np.int32)).cuda()
    wide = scan_assoc.assoc_scan(d_slice, ids_slice)
    check(torch.equal(wide, scan_dense.sequential_states(
        d_slice.reshape(-1), d_slice.shape[1], ids_slice)),
        "K12 over the slice's dictionary equals K2's one-thread form")
    wide_ms = cuda_ms(lambda: scan_assoc.assoc_scan(d_slice, ids_slice), 5)
    row["slice_dictionary_ms"] = wide_ms
    print(f"K12 over the slice's dictionary ({d_slice.shape[0]} states), "
          f"T={ASSOC_SLICE_T}: {wide_ms:.4f} ms, exact; "
          f"{ASSOC_SLICE_T * d_slice.shape[0]} lookups, bound "
          f"{lookup_bound_ms(ASSOC_SLICE_T * d_slice.shape[0]):.4f} ms",
          flush=True)
    return {"ac_assoc_scan": res}, launches


# The examples of examples_torch/, in the order phase_examples runs them,
# each with the kernels (or "entry/form") it must launch on the card: none
# for the two on the host, one a shard for the sharded demo.
EXAMPLES = {
    "demo": (),
    "generic_demo": ("ac_stepped_emit", "ac_stepped_count"),
    "needle_hunt_demo": ("ac_sparse_count_stepped/elided",
                         "ac_window_hits/elided"),
    "serving_demo": ("ac_stepped_count", "ac_stepped_emit"),
    "sharded_demo": ("ac_stepped_count", "ac_dense_states"),
    "host_parallel_demo": (),
}


def load_example(name: str):
    """examples_torch/<name>.py, loaded by path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_events(m, text, offset: int = 0, cur=None) -> list:
    """(start, end, keyword) of every match of ``text`` through the host
    cursor ``cur`` (a fresh one by default), longest first at each end
    (acm_get_match's index order), positions shifted by ``offset``."""
    cur = m.initiate() if cur is None else cur
    out = []
    for i, ch in enumerate(text):
        for j in range(m.match(cur, ch)):
            mt = m.get_match(cur, j)
            out.append((offset + i + 1 - mt.length, offset + i, mt.text()))
    return out


def test3_inputs(sc, text: np.ndarray, halo: int, unit: int):
    """Test 3's ids as count() stages them for a stream kernel: B =
    sc.n_streams streams of L ids (a multiple of ``unit``), zero-padded,
    behind ``halo`` OOV head ids; (B, L, ids on the card)."""
    B, L = sc._layout(len(text), unit)
    ids = np.zeros(halo + B * L, np.int32)
    ids[halo:halo + len(text)] = text
    return B, L, sc._snap.place(ids)


def touched(sc1, ids, B: int, L: int):
    """Distinct (state, letter) entries and distinct states the 1-char
    walk of B streams of L ids reads: the transition into body symbol t
    reads entry (state after t - 1, letter t), and K1 reads nb_out at the
    state it reaches, from K2's states over the same streams (each
    stream's first symbol left out: a lower bound of the bytes the data
    needs)."""
    from aho_corasick_1975_tpu_torch.ops import scan_dense
    snap = sc1._snap
    states = scan_dense.dense_states(snap.dflat, sc1.V, sc1.halo, B, L, ids,
                                     **sc1._dense_fields()).view(B, L).long()
    body = ids[sc1.halo:].view(B, L).long()
    keys = states[:, :-1] * sc1.V + body[:, 1:]
    return (int(torch.unique(keys).numel()),
            int(torch.unique(states[:, 1:]).numel()))


def check_generic(act, build, res: dict) -> dict:
    """Test 1: every event equals the host cursor's over the same text.
    Test 3: each round's total equals the native host scan of its ids on
    a machine built from the same keywords, its dictionary is past uint16
    state ids, and its scanner ("auto": the packed k = 1 table) ran K3 at
    k = 1. Then the user's step_k=1 scanner of round 3's dictionary counts
    the same ids through K1 with its tables in device memory, and K1 and
    K3 at round 3's tables and ids equal their plain versions."""
    from aho_corasick_1975_tpu_torch.ops import multistep, scan_dense
    t1 = res["test1"]
    want = host_events(t1["machine"], t1["text"])
    check(t1["events"] == want and len(want) > 0,
          f"generic Test 1: find_matches' {len(t1['events'])} events equal "
          f"the host cursor's {len(want)}")
    oracle = act.Machine()
    for c in range(26):
        oracle.vocab.register(chr(ord("a") + c))
    totals = []
    for rnd in res["test3"]:
        kws, text, sc = rnd["keywords"], rnd["text"], rnd["scanner"]
        oracle._b.insert_keywords_bulk(
            kws.reshape(-1), np.arange(len(kws) + 1, dtype=np.int64) * 7)
        _, want = oracle._b.match_bulk(0, text)
        check(rnd["total"] == want, f"generic Test 3: count {rnd['total']} "
              f"equals the native host scan {want}")
        check(sc.tables.n_states == oracle.n_states > 65536,
              f"generic Test 3: {sc.tables.n_states} states, past uint16")
        check(sc.step_k == 1 and sc._snap.packed is not None,
              "generic Test 3: 'auto' takes the packed k = 1 table")
        totals.append(want)
    sc = res["test3"][-1]["scanner"]
    text = res["test3"][-1]["text"]
    st, snap = sc._stepped, sc._snap
    sc1 = sc.machine.scanner(n_streams=sc.n_streams, step_k=1)
    n1, k1_launches = driven(build, ("ac_dense_count",),
                             "generic Test 3 step_k=1",
                             lambda: sc1.count(text))
    on_sm = build.dense_tables.get("ac_dense_count")
    check(n1 == totals[-1], f"step_k=1 count {n1} equals {totals[-1]}")
    check(on_sm == 0,
          f"K1 read {sc1.tables.n_states} states' tables from device memory "
          f"(shared-memory bytes {on_sm})")
    B, L, ids1 = test3_inputs(sc1, text, sc1.halo, 128)
    entries, states = touched(sc1, ids1, B, L)
    snap1 = sc1._snap
    k1 = compare(
        "ac_dense_count",
        functools.partial(scan_dense.dense_count, **sc1._dense_fields()),
        scan_dense.dense_count_plain,
        (snap1.dflat, snap1.nb_out, sc1.V, sc1.halo, B, L),
        {"test3_ids_i32": (ids1, None, None)},
        f"Test 3 B={B} L={L} S={sc1.tables.n_states}", hits=True,
        need=lambda *_: [(snap1.dflat, 4 * entries),
                         (snap1.nb_out, 4 * states)],
        steps=sc1.halo + L)
    B3, L3, ids3 = test3_inputs(sc, text, sc._halo_sym, 128 * st.k)
    k3 = compare(
        "ac_stepped_count",
        functools.partial(multistep.stepped_count,
                          warm_steps=sc._warm_steps),
        multistep.stepped_count_plain,
        (snap.packed, st.V, st.k, st.count_bits, sc._halo_steps, B3, L3),
        {"test3_k1_ids_i32": (ids3, None, None)},
        f"Test 3 B={B3} L={L3} k={st.k} S={sc.tables.n_states}", hits=True,
        need=lambda *_: [(snap.packed, 4 * entries)],
        steps=sc._halo_steps + L3 // st.k)
    return {"totals": totals, "n_states": sc.tables.n_states,
            "V": sc.V, "step_k": sc.step_k,
            "packed_bytes": nbytes(snap.packed),
            "dflat_bytes": nbytes(snap1.dflat),
            "entries_read": entries, "states_read": states,
            "step_k1_launches": k1_launches,
            "k1_tables_smem_bytes": on_sm, "k1": k1, "k3": k3}


def check_needle(act, res: dict) -> dict:
    """12 matches; the listed events are every occurrence of the
    signatures (found by search of the corpus) and the native host scan
    counts as many; the restore found them all."""
    mod = load_example("needle_hunt_demo")
    corpus = res["corpus"]
    want = []
    for sig in mod.SIGNATURES:
        p = corpus.find(sig)
        while p >= 0:
            want.append((p, p + len(sig) - 1, sig.decode()))
            p = corpus.find(sig, p + 1)
    want.sort(key=lambda e: (e[1], e[0]))
    m = act.Machine()
    for sig in mod.SIGNATURES:
        m.insert_keyword(sig)
    host = m.match_stream(m.initiate(), corpus, parallel=False)
    check(res["total"] == host == len(want) == 12,
          f"needle hunt: count {res['total']}, host scan {host}, "
          f"{len(want)} planted occurrences, 12 expected")
    check(res["events"] == want, "needle hunt: the listed events equal "
          "every occurrence of the signatures")
    check(res["found"] == res["total"]
          and res["offset"] == len(corpus) // 2 + 3,
          f"needle hunt: the restore at {res['offset']} found "
          f"{res['found']} of {res['total']}")
    return {"total": res["total"], "host": host}


def check_serving(act, res: dict) -> dict:
    """Every reply of demo() equals the host cursor's on the same
    stream: two FEEDs of one session, its TOTAL, the MATCHES after ADD
    pencil at absolute positions, and a second session's FEED."""
    text = GOLDEN
    m = act.Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    cur = m.initiate()
    n1 = m.match_stream(cur, text[:30])
    n2 = m.match_stream(cur, text[30:])
    m.insert_keyword("pencil")
    hits = [f"{s} {e} {kw}" for s, e, kw in
            host_events(m, " he lost his pencil again", len(text), cur)]
    n3 = m.match_stream(m.initiate(), "a pencil for hers")
    want = {"feed1": f"{n1} {n1}", "feed2": f"{n2} {n1 + n2}",
            "total": str(n1 + n2), "add": "OK", "hits": hits,
            "client2": f"{n3} {n3}"}
    check(res == want and n1 + n2 == 9, f"serving: replies {res} equal the "
          f"host cursor's {want}")
    return want


def check_sharded(act, res: dict) -> dict:
    """The mesh's total equals a DenseScanner's and the native host
    scan's, and its first events the host cursor's."""
    m, text = res["machine"], res["text"]
    dense = m.scanner().count(text)
    host = m.match_stream(m.initiate(), text, parallel=False)
    check(res["total"] == dense == host,
          f"sharded: total {res['total']} equals DenseScanner {dense} and "
          f"the host scan {host}")
    want = [(s, kw) for s, _, kw in host_events(m, text[:5000])[:5]]
    check(res["first"] == want and len(want) == 5,
          f"sharded: first events {res['first']} equal the host's {want}")
    return {"total": res["total"], "shards": res["mesh"].size}


def phase_examples(act, build) -> dict:
    """Each script of examples_torch/ loaded by path and run as
    ``main(device="cuda")`` with its stdout captured and the launch counters set
    to 0 just before and read just after, its result held against the
    port's native host oracle (``check_*``); the demo's golden line, the
    host-parallel demo's own asserts; each example's kernels of EXAMPLES
    launched. Returns, by example, its seconds, the kernels and forms it
    launched and the checks it passed."""
    out = {}
    for name, entries in EXAMPLES.items():
        mod = load_example(name)
        buf = io.StringIO()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {e: v for e, v in {**build.launches,
                                      **build.form_launches}.items() if v}
        for line in buf.getvalue().splitlines()[:12]:
            log(f"  {name}: {line}")
        each = res["mesh"].size if name == "sharded_demo" else 1
        check(all(launches.get(e, 0) >= each for e in entries)
              and (entries or not launches),
              f"{name} launched {entries or 'nothing'} ({each} each): "
              f"{launches}")
        row = {"seconds": secs, "launches": launches}
        if name == "demo":
            check(res == GOLDEN_LINE and GOLDEN_LINE in buf.getvalue(),
                  f"demo: golden line {res!r}")
            row["checks"] = ["golden line"]
        elif name == "generic_demo":
            row.update(check_generic(act, build, res))
            row["checks"] = ["Test 1 events == host cursor",
                             "Test 3 totals == native host scan",
                             "Test 3 states > 65536, K3 at k = 1",
                             "step_k=1: K1 with device-memory tables",
                             "K1, K3 at Test 3 == plain"]
        elif name == "needle_hunt_demo":
            row.update(check_needle(act, res))
            row["checks"] = ["12 matches == host scan",
                             "events == the signatures' occurrences",
                             "restore exact"]
        elif name == "serving_demo":
            check(buf.getvalue().rstrip().endswith("demo OK"),
                  "serving: the demo ends in 'demo OK'")
            row["replies"] = check_serving(act, res)
            row["checks"] = ["replies == host cursor", "demo OK"]
        elif name == "sharded_demo":
            row.update(check_sharded(act, res))
            row["checks"] = ["total == DenseScanner == host scan",
                             "first events == host cursor"]
        else:
            check(res["serial"] > 0 and all(
                res["seen"][0] <= n <= res["after"] for n in res["seen"]),
                "host-parallel: its counts")
            row["checks"] = ["serial == threaded", "monotone counts"]
        print(f"example {name}: {secs:.2f} s, launches {launches}, checks "
              f"{row['checks']}", flush=True)
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false); this smoke run needs the GPU")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build
    from aho_corasick_1975_tpu_torch.parallel.mesh import make_mesh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 1. build (its log kept: a later build, the host layer's, replaces
    # build.last_build)
    t0 = time.perf_counter()
    build.cuda_library()
    build_log = str(build.last_build["log"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.last_build['seconds']})", flush=True)
    log(build_log[-3000:])

    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)

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
    machine, text, ranked = slice_setup(act)
    sc = machine.scanner(n_streams=N_STREAMS)
    sc1 = machine.scanner(n_streams=N_STREAMS, step_k=1)
    tabs = sc.tables
    print(f"slice: {len(text)} bytes, {tabs.n_states} states, V={sc.V}, "
          f"step_k={sc.step_k}, count_bits={sc._stepped.count_bits}, "
          f"halo={sc.halo}, halo_steps={sc._halo_steps}, packed "
          f"{sc._snap.packed.numel() * 4} bytes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kern = phase_kernels(sc, text, max(ranked[:N_KEYWORDS], key=len))

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
    with plain_ops("hits_extract_dense"):   # the slice's refinement
        check(len(sc.find_matches(text)) == n, "timed find_matches")
    mib = len(text) / 2 ** 20
    print(f"slice: count {n} == host oracle ({oracle_s:.2f} s); "
          f"count() first {count_s:.4f} s, then "
          f"{', '.join(f'{t:.4f}' for t in count_times)} s = "
          f"{mib / min(count_times):.1f} MiB/s; find_matches() first "
          f"{find_s:.4f} s, then {', '.join(f'{t:.4f}' for t in find_times)}"
          f" s = {mib / min(find_times):.1f} MiB/s; {len(ms)} matches",
          flush=True)

    # the staging ring: floors, overlap, sweep, stale slots
    t0 = time.perf_counter()
    staging = phase_staging(act, build, machine, sc, sc1, text, n, ranked)
    print(f"staging phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. K5 and K6 against their plain versions at config 3's shapes
    t0 = time.perf_counter()
    m3, docs = config3_setup(act)
    sc_cm = m3.scanner(n_streams=N_STREAMS)
    print(f"config 3: {m3.n_states} states, V={sc_cm.V}, "
          f"step_k={sc_cm.step_k}, halo={sc_cm.halo}, packed "
          f"{sc_cm._snap.packed.numel() * 4} bytes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kern.update(phase_batch_kernels(sc_cm, docs, sc, sc1, text))
    del sc_cm

    # 6. count_many at config 3
    launches.update({e: v for e, v in phase_count_many(
        build, m3, docs, mesh).items()
                     if e in ("ac_stepped_count_many", "ac_dense_count_many")})
    del m3

    # 7. sessions over the slice corpus
    phase_sessions(act, build, machine, sc, text, n, ms.ends,
                   min(count_times))

    # 8. refresh at bench_refresh.py's shape (the snapshot's refresh timed)
    with plain_ops("refresh"):
        phase_refresh(act, build)

    # 9. the sparse prefilter: (a)-(b), (c) the auto gate, (d) kernels
    state, sparse_launches = phase_sparse(act, build)
    launches.update({e: sparse_launches.get(e, 0) for e in (
        "ac_sparse_count", "ac_sparse_count_stepped", "ac_window_hits",
        "ac_dense_states/seq", "ac_dense_states_tm")})
    gate = phase_gate(build, machine, text, n, ms.ends)
    launches["ac_dense_hits"] = gate["launches"]["ac_dense_hits"]
    kern.update(phase_sparse_kernels(build, state, gate, text))

    # 10. the two-table count, forced, on the slice's dictionary
    L2 = min(len(text) // CM_DOCS, 1 << 18)
    docs2 = [text[i * L2:(i + 1) * L2] for i in range(CM_DOCS)]
    two, two_launches = phase_two_table(act, build, ranked, text, n,
                                        gate["t_ids"], docs2)
    # 11. the hybrid engine on the slice
    hyb, hyb_launches = phase_hybrid(act, build, ranked, text, n,
                                     gate["t_ids"], min(count_times))
    # 12. the MXU engine: the slice's corpus, config 3, the hunt
    mxu, mxu_launches = phase_mxu(act, build, ranked, text, docs,
                                  state["text"], state["hunt_n"])
    # 13. calibration
    phase_calibration(act, ranked, mxu["N"])
    # 14. K9-K11 against their plain versions
    kern.update(phase_engine_kernels(two, hyb, mxu, text, docs, kern))
    launches["ac_stepped_count_2t"] = two_launches["ac_stepped_count_2t"]
    launches["ac_mxu_count"] = mxu_launches["ac_mxu_count"]
    launches["ac_hybrid_count"] = hyb_launches["ac_hybrid_count"]
    # 15. the mesh: logical shards on cuda:0, NCCL, every card
    t0 = time.perf_counter()
    phase_mesh(act, build, mesh, machine, sc, sc1, text, n, ms,
               gate["t_ids"], ranked, mxu, state)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # 16. K12 against its plain version and K2's one-thread form
    assoc, assoc_launches = phase_assoc(act, build, sc, text)
    kern.update(assoc)
    launches["ac_assoc_scan"] = assoc_launches["ac_assoc_scan"]
    # 17. the examples of examples_torch/, each through main(device="cuda")
    t0 = time.perf_counter()
    examples = phase_examples(act, build)
    kern["ac_dense_count"].update(examples["generic_demo"]["k1"])
    kern["ac_stepped_count"].update(examples["generic_demo"]["k3"])
    print(f"examples phase: {time.perf_counter() - t0:.1f} s", flush=True)

    def first(entry, key):
        return next(iter(kern[entry].values())).get(key)

    ptxas = ptxas_kernels(build_log)
    for name, regs, st_b, ld_b in ptxas:
        if any(re.search(p, name) for p in SPLIT_KERNELS.values()):
            print(f"ptxas: {name}: {regs} registers, spill {st_b} bytes "
                  f"stored, {ld_b} loaded", flush=True)

    print(json.dumps({"staging": staging}), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[entry],
         "max_abs_err": max(r["max_abs_err"] for r in kern[entry].values()),
         "ms": first(entry, "ms"), "plain_ms": first(entry, "plain_ms"),
         "bound_ms": first(entry, "bound_ms"),
         "bound_by": first(entry, "bound_by"), "library_ms": None,
         "split": first(entry, "split"),
         "ns_per_step": first(entry, "ns_per_step"),
         "ms_by_split": first(entry, "ms_by_split"),
         "ms_by_split_read_only": first(entry, "ms_by_split_read_only"),
         "ms_read_only": first(entry, "ms_read_only"),
         "passes": first(entry, "passes"),
         "phases": first(entry, "phases"),
         "device_ms": first(entry, "device_ms"),
         "lookup_bound_ms": first(entry, "lookup_bound_ms"),
         "seq_ms": first(entry, "seq_ms"),
         "slice_dictionary_ms": first(entry, "slice_dictionary_ms"),
         "enqueue_ms": first(entry, "enqueue_ms"),
         "registers": registers_of(ptxas, entry)}
        for entry, (name, src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"plain_ops": plain_ops_line()}), flush=True)
    print(json.dumps({"mesh": {"device": kind, "shards": MESH_SHARDS,
                               "n_streams_per_device": MESH_STREAMS,
                               "paths": MESH_PATHS}}), flush=True)
    print(json.dumps({"examples": examples}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
