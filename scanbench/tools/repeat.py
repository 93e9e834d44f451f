"""Run one cell several times, each run a process of its own as the
benchmark's check runs it, and summarise: per metric the values, the
median and the spread (the distance between the first and third quartile,
``statistics.quantiles(values, n=4)``, over the median).

    python3 scanbench/tools/repeat.py --workload words1000.count_64m \
        --seeds 101,102,103 --seconds 30 --trace 0 --out build/scanbench/a.jsonl

Each run's result line (or its failure) goes to ``--out`` as one JSON line
with the seed, the exit code and the end of its standard error.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="30")
    p.add_argument("--trace", default="0")
    p.add_argument("--out", required=True)
    p.add_argument("--keep", action="store_true",
                   help="copy each run's spans (and trace) beside --out")
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    got: dict = {}
    with open(args.out, "a") as out:
        for seed in args.seeds.split(","):
            cmd = [sys.executable, os.path.join(ROOT, "scanbench", "run.py"),
                   "--workload", args.workload, "--seed", seed,
                   "--seconds", args.seconds, "--trace", args.trace]
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() \
                else ""
            rec = {"workload": args.workload, "seed": int(seed),
                   "trace": int(args.trace), "rc": r.returncode,
                   "stderr_tail": r.stderr[-3000:]}
            try:
                rec["result"] = json.loads(line)
            except json.JSONDecodeError:
                rec["result"] = None
            if args.keep:
                for kind in ("spans.jsonl", "trace.json"):
                    src = os.path.join(ROOT, "build", "scanbench",
                                       f"{args.workload}.{kind}")
                    if os.path.exists(src):
                        shutil.copy(src, f"{args.out}.{seed}.{kind}")
            out.write(json.dumps(rec) + "\n")
            out.flush()
            res = rec["result"] or {}
            print(json.dumps({"seed": seed, "rc": r.returncode,
                              "correct": res.get("correct"),
                              "attempted": res.get("attempted"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "busy_s": res.get("device", {}).get("busy_s"),
                              "window_s": res.get("device", {}).get(
                                  "window_s"),
                              "peak": res.get("device", {}).get(
                                  "memory_peak_bytes")}), flush=True)
            for k, v in res.get("metrics", {}).items():
                got.setdefault(k, []).append(v["value"])
    for k, vals in got.items():
        print(json.dumps({"metric": k, "n": len(vals),
                          "median": statistics.median(vals),
                          "spread": spread(vals), "values": vals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
