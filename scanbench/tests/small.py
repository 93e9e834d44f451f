"""Small sizes of every cell, for the CPU tests: the same loops, mixes and
comparison, with dictionaries and texts that a test run can hold, and
dense enough in matches that a lost one shows."""

import time

from scanbench.harness import core

CONFIG = {"random7x250k": {"increments": 4, "keywords_per_increment": 60,
                           "keyword_letters": 5, "alphabet": "abcd"}}
TRAFFIC = {
    "words1000.count_64m": {"doc_bytes": 1 << 16},
    "words1000.retrieve_64m": {"doc_bytes": 1 << 16},
    "random7x250k.increments": {"text_bytes": 4096},
}


def run(workload: str, seed: int = 5, seconds: float = 0.5,
        trace: bool = False, control: bool = False, device="cpu") -> dict:
    return core.run_cell(workload, seed, seconds, trace,
                         time.perf_counter(), device=device,
                         control=control,
                         config_overrides=CONFIG.get(workload.split(".")[0]),
                         traffic_overrides=TRAFFIC[workload])
