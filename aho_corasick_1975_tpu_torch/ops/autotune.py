"""One-shot engine calibration on the scanner's device.

The port of ``ops/autotune.py``. ``DenseScanner(calibrate=True)`` with
``engine="auto"`` runs each available engine's production ``count()`` on a
synthetic corpus once, keeps the fastest and caches the choice, in the
process and in the JSON file ``ACX_AUTOTUNE_CACHE`` (the JAX package's
file). The key names the framework, the backend, the device and the
automaton's geometry, and starts with ``torch|``, so that a choice the
JAX package measured (its keys start with its backend) never steers the
port, nor the reverse.

The probe corpus is uniform random ids over the automaton's vocabulary.
Its size, ``PROBE_SYMBOLS``, is the JAX package's; whether it suits the
card is to be measured (ROADMAP).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

PROBE_SYMBOLS = 1 << 21

_MEM: Dict[str, str] = {}
_LOCK = threading.Lock()


def cache_path() -> str:
    return os.environ.get(
        "ACX_AUTOTUNE_CACHE",
        os.path.join(tempfile.gettempdir(), "acx_autotune.json"))


def geometry_key(n_states: int, V: int, step_k: int, device) -> str:
    """torch|backend|device name|S bucket|V|k."""
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    s_bucket = 1 << max(0, int(n_states - 1).bit_length())  # pow2 bucket
    return "|".join(["torch", dev.type, kind, f"S{s_bucket}", f"V{V}",
                     f"k{step_k}"])


def cached_choice(key: str) -> Optional[str]:
    with _LOCK:
        if key in _MEM:
            return _MEM[key]
        try:
            with open(cache_path()) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            return None
        _MEM.update(disk)
        return _MEM.get(key)


def store_choice(key: str, engine: str) -> None:
    with _LOCK:
        _MEM[key] = engine
        path = cache_path()
        try:
            try:
                with open(path) as f:
                    disk = json.load(f)
            except (OSError, ValueError):
                disk = {}
            disk[key] = engine
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(disk, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # the cache file is an optimisation, never a failure


def probe(scanner, candidates, reps: int = 2) -> str:
    """Time the production count() of each candidate engine on a seeded
    random corpus of ``PROBE_SYMBOLS`` ids (best of ``reps`` after one
    warm-up); fill ``scanner.stats["calibration"]`` and return the
    fastest engine's name. The scanner is rebound per candidate under its
    dispatch lock (reentrant, so the probe's own count() calls take it
    again); the caller binds the winner."""
    with scanner._dispatch:
        ids = np.random.default_rng(0).integers(
            0, scanner.V, size=PROBE_SYMBOLS, dtype=np.int32)
        timings = {}
        for name in candidates:
            scanner._engine = name
            scanner._bind()
            scanner.count(ids)
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                scanner.count(ids)
                best = min(best, time.perf_counter() - t0)
            timings[name] = best
        winner = min(timings, key=timings.get)
        scanner.stats["calibration"] = {k: round(v, 5)
                                        for k, v in timings.items()}
        return winner
