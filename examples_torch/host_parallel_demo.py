"""Host-side parallel matching on the PyTorch/CUDA port: the counterpart
of examples/host_parallel_demo.py, lock-free scans + threads, no device.

The reference advertises concurrent insert + scan on one machine
(README.md:364) — its match loop takes no lock. The port's native core
(its own copy, aho_corasick_1975_tpu_torch/native/acx.cpp) keeps that
property (published-shadow readers) and builds on it, because lock-free
matchers can fan out across cores with zero coordination:

* ``match_stream(cur, text, parallel=True)`` — ONE long stream split
  into halo-blocked chunks, each warmed up from the root over the
  longest-keyword tail before it (exact by the suffix property of AC
  states). Near-linear with cores.
* ``match_stream_many(docs)`` — a document batch fanned across threads,
  contiguous ranges balanced by symbol mass.
* All of it safe WHILE another thread registers keywords: matchers
  never block, and every keyword fully registered before a call begins
  is counted (the monotonicity contract).

Every step runs on the host: no step of this demo uses ``device``, which
is taken for the command line the other examples share.

Run: python3 examples_torch/host_parallel_demo.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import random
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import aho_corasick_1975_tpu_torch as act


def main(device="cuda") -> dict:
    """Runs the three host scans and their asserts; returns the single
    stream's count, the batch's total and the concurrent scans' counts."""
    rng = random.Random(0)
    m = act.Machine()
    for _ in range(500):
        m.insert_keyword("".join(rng.choice("abcdef")
                                 for _ in range(rng.randint(3, 8))))

    text = "".join(rng.choice("abcdefg ") for _ in range(4_000_000))

    # 1. one stream, all cores
    cur = m.initiate()
    t0 = time.perf_counter()
    serial = m.match_stream(cur, text, parallel=False)
    dt_serial = time.perf_counter() - t0
    cur = m.initiate()
    t0 = time.perf_counter()
    parallel = m.match_stream(cur, text, parallel=True)
    dt_parallel = time.perf_counter() - t0
    assert serial == parallel
    print(f"single stream : {serial} matches | "
          f"serial {len(text) / dt_serial / 1e6:.0f} MB/s -> "
          f"threaded {len(text) / dt_parallel / 1e6:.0f} MB/s")

    # 2. document batch, threaded fan-out
    docs = [text[i:i + 20_000] for i in range(0, 1_000_000, 20_000)]
    t0 = time.perf_counter()
    totals = m.match_stream_many(docs)
    dt = time.perf_counter() - t0
    print(f"batch scoring : {len(docs)} docs, {int(totals.sum())} matches "
          f"in {dt * 1e3:.1f} ms")

    # 3. scans never block behind registration (lock-free matchers)
    seen = []

    def scan_loop():
        for _ in range(20):
            c = m.initiate()
            seen.append(m.match_stream(c, text[:200_000]))

    t = threading.Thread(target=scan_loop)
    t.start()
    for _ in range(200):  # concurrent online registration
        m.insert_keyword("".join(rng.choice("abcdef")
                                 for _ in range(rng.randint(3, 8))))
    t.join()
    c = m.initiate()
    after = m.match_stream(c, text[:200_000])
    # pre-registered keywords are never missed; nothing beyond the final
    # dictionary is ever counted
    assert all(seen[0] <= n <= after for n in seen)
    print(f"concurrent    : 20 scans during 200 online inserts, counts "
          f"{min(seen)}..{max(seen)} (monotone, never blocked)")
    return {"serial": serial, "batch": int(totals.sum()), "seen": seen,
            "after": after}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
