"""The program's own spans in the window's traced calls: what the
``program_span`` and ``program_counter`` readers read.

The port records spans inside itself (``ac.*``, its
``utils/profiling.py``) while a profiler runs, which in a ``--trace 1``
run is the traced part of the window. Their times are ns on
``time.perf_counter_ns()``, the clock of the harness's ``Call.t0``/``t1``,
so each record is placed in the traced call whose interval holds it. A
program without the recorder, or a run with no traced call, gives None,
and the readers then give None: nothing is raised. The records of the
traced calls are written once to ``build/scanbench/<cell>.program_spans
.jsonl``, each with ``harness_call``, the index of its call in the
window."""

from __future__ import annotations

import json
from typing import Optional

from . import spec


def _records() -> Optional[list]:
    """The program's records, or None where it has no recorder."""
    from aho_corasick_1975_tpu_torch.utils import profiling
    read = getattr(profiling, "records", None)
    return None if read is None else read()


def traced(run) -> Optional[list]:
    """[(call, [record, ...]), ...] for each traced call of the window
    without an error, its records oldest first; None where the program
    has no recorder or no call was traced."""
    memo = getattr(run, "_program_spans", None)
    if memo is not None:
        return memo or None
    recs = _records()
    calls = [c for c in run.window.calls if c.traced and c.error is None]
    out: list = []
    if recs is not None and calls:
        out = [(c, [r for r in recs if int(c.t0 * 1e9) <= r["t0"]
                    and r["t1"] <= int(c.t1 * 1e9)]) for c in calls]
        _write(run, out)
    run._program_spans = out
    return out or None


def _write(run, per_call) -> None:
    path = spec.OUT_DIR / f"{run.cell.name}.program_spans.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for i, (_, recs) in enumerate(per_call):
            for r in recs:
                f.write(json.dumps({**r, "harness_call": i}, default=str)
                        + "\n")


def _ms(r: dict) -> float:
    return (r["t1"] - r["t0"]) / 1e6


def self_ms(rec: dict, recs: list) -> float:
    """``rec``'s duration less the part of it its children cover, in ms."""
    kids = sorted((r["t0"], r["t1"]) for r in recs
                  if r.get("parent") == rec["id"])
    covered, end = 0, rec["t0"]
    for a, b in kids:
        a, b = max(a, end), min(b, rec["t1"])
        if b > a:
            covered += b - a
            end = b
    return (rec["t1"] - rec["t0"] - covered) / 1e6


def _units(run, root: Optional[str]) -> Optional[list]:
    """The record lists of the units: each traced call's (``root`` None),
    or each ``root`` span's and its descendants' (one call id) in the
    traced calls."""
    per_call = traced(run)
    if per_call is None:
        return None
    if root is None:
        return [recs for _, recs in per_call]
    units = []
    for _, recs in per_call:
        for r in recs:
            if r["name"] == root and r.get("parent") is None:
                units.append([x for x in recs if x.get("call") == r["id"]])
    return units


def mean_per_unit(run, name: str, value, root: Optional[str] = None
                  ) -> Optional[float]:
    """The mean over the units (``_units``) of ``value(record, unit)``
    summed over the unit's records named ``name``; None where no unit
    holds such a record."""
    units = _units(run, root)
    if not units:
        return None
    sums = [sum(value(r, u) for r in u if r["name"] == name) for u in units]
    if not any(r["name"] == name for u in units for r in u):
        return None
    return sum(sums) / len(units)


def span_ms(run, name: str, root: Optional[str] = None) -> Optional[float]:
    """The mean time in spans ``name`` per unit, in ms."""
    return mean_per_unit(run, name, lambda r, u: _ms(r), root)


def span_self_ms(run, name: str, root: Optional[str] = None
                 ) -> Optional[float]:
    """The mean self time of spans ``name`` per unit, in ms."""
    return mean_per_unit(run, name, self_ms, root)


def span_count(run, name: str, root: Optional[str] = None
               ) -> Optional[float]:
    """The mean number of spans ``name`` per unit."""
    return mean_per_unit(run, name, lambda r, u: 1, root)
