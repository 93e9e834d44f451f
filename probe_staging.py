"""The slice's host-input paths on one NVIDIA GPU (an H100), for this
checkout's package and, with --old, for another checkout's, in turns.

    python3 probe_staging.py [--old DIR]

DIR is the root of another checkout of the repository, e.g. the commit
before the staging ring (models/staging.py):

    mkdir -p build/old
    git archive REV | tar -x -C build/old
    python3 probe_staging.py --old build/old

Each turn is a process of its own that imports the package of one root,
builds its kernels, and times on chip_smoke.py's slice (bench.py's 1,000
keywords over its corpus tiled to 64 MiB, 16,384 streams) the three paths
that upload host bytes: count() from bytes (5 runs after a warm-up),
find_matches() (2 runs) and a session's feed_count over
chip_smoke.session_chunks (121 chunks, 2 runs), each on the wall clock
(``chip_smoke.wall_ms``) and each equal to the native host scan. With
--old the turns run old, new, new, old, so that a drift of the card
shows; each prints one JSON line, and the last line gathers them.
Imports nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
COUNT_RUNS, RETRIEVAL_RUNS = 5, 2


def turn(root: str) -> dict:
    """The three paths of the package under ``root``, in this process;
    chip_smoke.py is this checkout's whatever the root."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(root))
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.cuda_library()
    build_s = time.perf_counter() - t0
    machine, text, _ = cs.slice_setup(act)
    sc = machine.scanner(n_streams=cs.N_STREAMS)
    n = machine.match_stream(machine.initiate(), text, parallel=False)
    chunks = cs.session_chunks(text)

    def feed():
        s = sc.session()
        for ch in chunks:
            s.feed_count(ch)
        return s.total

    count_ms, got = cs.wall_ms(lambda: sc.count(text), COUNT_RUNS)
    find_ms, found = cs.wall_ms(lambda: len(sc.find_matches(text)),
                                RETRIEVAL_RUNS)
    sess_ms, totals = cs.wall_ms(feed, RETRIEVAL_RUNS)
    for what, vals in (("count", got), ("find_matches", found),
                       ("sessions", totals)):
        cs.check(set(vals) == {n}, f"{what} {vals} equal the host oracle "
                 f"{n}")
    return {"root": root, "package": act.__file__,
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "bytes": len(text), "matches": n, "session_chunks": len(chunks),
            "count_ms": count_ms, "find_matches_ms": find_ms,
            "sessions_ms": sess_ms}


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of another checkout")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    opts = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("probe_staging: no CUDA device", file=sys.stderr)
        return 1
    if opts.turn:
        print(json.dumps(turn(opts.turn)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    roots = [REPO, REPO] if not opts.old else [opts.old, REPO, REPO,
                                               opts.old]
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root], capture_output=True,
                              text=True, timeout=600, cwd=REPO)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(json.dumps({"staging_probe": {"card": smi, "turns": [
        {"old" if r["root"] != REPO else "new": {
            k: r[k] for k in ("count_ms", "find_matches_ms", "sessions_ms")}}
        for r in runs]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
