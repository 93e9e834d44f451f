"""Spans from the benchmark's own files around each call into the program:
name, start and end on the host clock, the span that caused it, and the
request or increment it belongs to. Kept in memory during the window and
written out after it. While the device is traced each span is also a
``torch.profiler`` annotation of the same name, so that the trace's
reduction can find the calls."""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator

import torch


class Spans:
    def __init__(self):
        self.records: list = []
        self.profiling = False
        self._open: list = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[dict]:
        rec = {"name": name, "parent": self._open[-1] if self._open else None,
               **attrs}
        idx = len(self.records)
        self.records.append(rec)
        self._open.append(idx)
        ann = (torch.profiler.record_function(name) if self.profiling
               else contextlib.nullcontext())
        rec["t0"] = time.perf_counter()
        try:
            with ann:
                yield rec
        finally:
            rec["t1"] = time.perf_counter()
            self._open.pop()

    def named(self, name: str) -> list:
        return [r for r in self.records if r["name"] == name and "t1" in r]

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=str) + "\n")
