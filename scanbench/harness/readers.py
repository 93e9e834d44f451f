"""What the metric readers share (``metrics/<name>.py``, each a few lines
over these): rates and tails of the window's calls, span means, and the
device trace's reductions. Each returns None where the run has nothing to
read, and the harness then leaves the metric out."""

from __future__ import annotations

import statistics
from typing import Optional

from .. import roofline


def _calls(run, op: str) -> list:
    return [c for c in run.window.calls if c.op == op and c.error is None]


def gbps(run, op: str) -> Optional[float]:
    """Bytes passed to ``op`` in the window over the window's seconds, in
    GB/s (1e9 bytes)."""
    calls = _calls(run, op)
    if not calls or run.traffic.get("op") != op:
        return None
    return sum(c.nbytes for c in calls) / run.window.seconds / 1e9


def per_unit_ms(run) -> Optional[float]:
    """The window's seconds over the units it completed, in ms."""
    if not run.window.units:
        return None
    return run.window.seconds / run.window.units * 1e3


def span_mean_ms(run, name: str) -> Optional[float]:
    """The mean of the window's spans called ``name``, in ms."""
    t0, t1 = run.window.t0, run.window.t1
    d = [r["t1"] - r["t0"] for r in run.spans.named(name)
         if t0 <= r["t0"] <= t1]
    return statistics.fmean(d) * 1e3 if d else None


def inplace_share(run) -> Optional[float]:
    got = run.window.refreshed
    return sum(map(bool, got)) / len(got) if got else None


def device_idle(run) -> Optional[float]:
    """The share of the traced part with nothing on the device."""
    tr = run.trace
    if tr is None or not tr.busy:
        return None
    return 1.0 - tr.busy_s() / tr.window_s


def host_ms(run, op: str) -> Optional[float]:
    """The traced ``op`` calls' mean wall time less their mean device busy
    time, in ms."""
    tr = run.trace
    calls = tr.calls(op) if tr is not None else []
    if not calls or not tr.busy:
        return None
    wall = sum(b - a for a, b in calls) / 1e6
    busy = sum(tr.busy_s(a, b) for a, b in calls)
    return (wall - busy) / len(calls) * 1e3


def scan_roofline(run, op: str) -> Optional[float]:
    """The least time the traced ``op`` calls' scans need
    (``roofline.scan_bytes`` of the reference's automaton, over the card's
    bandwidth) over the summed time of every kernel they launched, in %."""
    tr = run.trace
    spans = tr.calls(op) if tr is not None else []
    sizes = [c.nbytes for c in run.window.calls if c.traced and c.op == op]
    kernel_s = sum(tr.kernel_s(a, b) for a, b in spans) if spans else 0.0
    if not spans or len(sizes) != len(spans) or kernel_s <= 0:
        return None
    g = run.geometry
    least = sum(roofline.least_seconds(roofline.scan_bytes(
        n, g["n_states"], g["n_classes"])) for n in sizes)
    return 100.0 * least / kernel_s
