"""Tracing and profiling helpers: the port of ``utils/profiling.py``.

* ``PhaseTimer``: structured wall-clock phases (build / upload / scan /
  decode) accumulated into a dict, as in the JAX package;
* ``device_trace``: a ``torch.profiler`` trace of the CPU and, where the
  machine has one, the CUDA device around any scan call, written into
  ``logdir`` as a Chrome trace. PyTorch returns before the device finishes,
  so a wall-clock phase around device work ends in a synchronous read of
  its result (``int(...)``, ``.cpu()``), which is what scanner.stats
  records.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseTimer:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> Dict[str, dict]:
        return {k: {"seconds": round(v, 6), "calls": self.calls[k]}
                for k, v in sorted(self.seconds.items())}


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace around a block, CUDA activity included
    where CUDA is present; the Chrome trace goes to
    ``logdir/trace_<pid>_<ns>.json`` (open it in chrome://tracing or
    Perfetto). Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
