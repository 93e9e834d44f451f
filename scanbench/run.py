"""Run one cell of the benchmark once and print its result line.

    python3 scanbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, their configurations, traffic mixes and metrics are in
``BENCHMARK.json`` at the root of the checkout. The run needs the card(s)
its cell asks for: without them it exits with a non-zero code and prints no
result. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; last, ``checks``: each number compared with its limit); the
last lines of standard error give the same checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from scanbench.harness import core, guard
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START)
    except core.NoCard as e:
        core.log(f"no result: {e}")
        return 3
    found = guard.loaded()
    if found:
        core.log(f"no result: {', '.join(found)} loaded in this process")
        return 4
    for name, c in result["checks"].items():
        core.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
