"""The device trace of a bounded part of the window (``--trace 1``), and
its reduction: the device's busy intervals (kernels, copies and memsets,
their union), the calls' annotations from the spans, the operations that
took most time and the longest idle gaps by what the host was doing.

Times are microseconds on the profiler's clock, which the host's
annotations and the device's activity share."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

WINDOW = "scanbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96


class Tracer:
    """Starts and stops ``torch.profiler`` around a part of the window; the
    part is marked by a ``WINDOW`` annotation, and every span inside it
    by its own (``Spans.profiling``)."""

    def __init__(self, spans, device: torch.device, path: Path):
        self.spans, self.device, self.path = spans, device, path
        self.data: Optional[TraceData] = None
        self._prof = self._mark = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        (CUPTI's) takes seconds, which would otherwise fall in the
        window."""
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.spans.profiling = True

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self.spans.profiling = False
        self._prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        with open(self.path) as f:
            self.data = TraceData.from_events(json.load(f)["traceEvents"])


def _union(spans) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, t0: float, t1: float) -> float:
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in intervals)


@dataclass
class TraceData:
    window: tuple                 # (t0, t1) of the traced part
    device: list                  # (t0, t1, name, cat), device activity
    annotations: list             # (t0, t1, name), the spans
    host_ops: list                # (t0, t1, name), the host's operators
    busy: list = field(default_factory=list)   # union of ``device``

    @classmethod
    def from_events(cls, events) -> "TraceData":
        xs = [e for e in events if e.get("ph") == "X"]

        def span(e):
            t0 = float(e["ts"])
            return t0, t0 + float(e.get("dur", 0.0)), e.get("name", "")

        ann = [span(e) for e in xs if e.get("cat") == "user_annotation"]
        marks = [a for a in ann if a[2] == WINDOW]
        if not marks:
            raise RuntimeError("the trace has no window annotation")
        window = marks[0][:2]
        device = [span(e) + (e["cat"],) for e in xs
                  if e.get("cat") in DEVICE_CATS]
        host = [span(e) for e in xs if e.get("cat") == "cpu_op"]
        data = cls(window, device, [a for a in ann if a[2] != WINDOW], host)
        data.busy = _union([(a, b) for a, b, _, _ in device])
        return data

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, t0: Optional[float] = None,
               t1: Optional[float] = None) -> float:
        """Seconds in which something ran on the device in [t0, t1] (the
        traced part by default)."""
        return _clip(self.busy, self.window[0] if t0 is None else t0,
                     self.window[1] if t1 is None else t1) / 1e6

    def calls(self, name: str) -> list:
        """(t0, t1) of each annotation ``name``, in order."""
        return [(a, b) for a, b, n in self.annotations if n == name]

    def kernel_s(self, t0: float, t1: float) -> float:
        """Summed seconds of the kernels that started in [t0, t1]."""
        return sum(b - a for a, b, _, cat in self.device
                   if cat == "kernel" and t0 <= a <= t1) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time in
        the traced part."""
        tot: dict = {}
        for a, b, name, _ in self.device:
            if self.window[0] <= a <= self.window[1]:
                key = name[:NAME_CHARS]
                tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost span and the
        innermost host operator around it."""
        def inner(items):
            best = None
            for a, b, name in items:
                if a <= t <= b and (best is None or a >= best[0]):
                    best = (a, name)
            return best[1] if best else None
        span, op = inner(self.annotations), inner(self.host_ops)
        parts = [p for p in (span, op) if p]
        return (" > ".join(parts) if parts else "between calls")[:NAME_CHARS]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the ``n`` longest gaps in
        the traced part with nothing on the device."""
        edges = [self.window[0]]
        for a, b in self.busy:
            if b < self.window[0] or a > self.window[1]:
                continue
            edges += [max(a, self.window[0]), min(b, self.window[1])]
        edges.append(self.window[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:n]]
