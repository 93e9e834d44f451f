"""One run of one cell: make the inputs from the seed, build the automaton
through the program's public API, warm up the cell's own calls, measure
for ``seconds``, then read the metrics and check every answer against the
plain reference."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import check, loops, spec
from ..reference import Reference
from .spans import Spans
from .trace import TraceData, Tracer


class NoCard(RuntimeError):
    """The cell's cards are not there: the run measures nothing."""


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    cell: spec.Cell
    seed: int
    seconds: float
    setup_s: float
    window: loops.Window
    spans: Spans
    trace: Optional[TraceData]
    geometry: dict

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def cards(chips: int) -> torch.device:
    """The first of ``chips`` CUDA cards, or NoCard."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


class PowerLimit:
    """The card's power limit as nvidia-smi reads it: started at once,
    read (and waited for) with ``read()``, so that it runs during set-up
    and never outlives the run."""

    def __init__(self, device: torch.device):
        self.device, self.proc, self.error = device, None, None
        if device.type != "cuda":
            return
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", "-i", str(device.index or 0)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError as e:
            self.error = f"unknown ({type(e).__name__})"

    def read(self) -> str:
        if self.proc is None:
            return self.error or "none (not a card)"
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return "unknown (nvidia-smi timed out)"
        return out.strip() or f"unknown (rc {self.proc.returncode})"


def geometry(ref: Reference) -> dict:
    """The configuration's automaton's shape as the plain reference builds
    it, for the roofline: nothing of how the program holds its tables."""
    return {"n_states": int(ref.n_states), "n_classes": int(ref.n_classes)}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[str] = None,
             control: bool = False,
             config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None) -> dict:
    """The result line's object. ``device`` None is the card the cell
    asks for (NoCard without it); tests pass "cpu". ``control`` runs the
    program with a guarantee switched off (the comparison must fail it):
    no halo between streams, or no refresh after an increment."""
    cell = spec.find_cell(spec.load_benchmark(), workload)
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
    loop, op = loops.resolve(cell)
    dev = cards(cell.workload["chips"]) if device is None \
        else torch.device(device)
    import aho_corasick_1975_tpu_torch as act
    from aho_corasick_1975_tpu_torch.ops import build
    smi = PowerLimit(dev)
    gen = cell.generator()
    t0 = time.perf_counter()
    dep = gen.make(cell.config, seed, dev)
    t_inputs = time.perf_counter()
    spans = Spans()
    tracer = None
    if trace:
        tracer = Tracer(spans, dev, spec.OUT_DIR / f"{workload}.trace.json")
        tracer.warm()
    prog = loops.Program(act, spans, dev, control)
    marks: dict = {}
    traffic = cell.traffic

    def setup_done():
        # the harness's own objects are not the program's garbage: no
        # collection of them falls in the window
        gc.collect()
        gc.freeze()
        marks["setup"] = time.perf_counter()

    try:
        win, state, texts = loop.run(prog, dep, traffic, op, seconds,
                                     tracer, setup_done, seed)
    finally:
        gc.unfreeze()
        power = smi.read()
    setup_s = marks["setup"] - t_start
    if dev.type == "cuda":
        log(f"card: {torch.cuda.get_device_name(dev)}, power limit {power}, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.get_num_threads()} host threads")
    log(f"set-up {setup_s:.3f} s: imports and the card {t0 - t_start:.3f} s,"
        f" inputs {t_inputs - t0:.3f} s, then build and warm-up; nvcc "
        f"{build.last_build['seconds']} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    state = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = Reference([kw for inc in dep.increments for kw in inc], dev)
    geo = geometry(ref)
    run = Run(cell, seed, seconds, setup_s, win, spans,
              tracer.data if tracer else None, geo)
    spans.write(spec.OUT_DIR / f"{workload}.spans.jsonl")
    errors = [c.error for c in win.calls if c.error]
    if errors:
        log(f"{len(errors)} calls raised; the first: {errors[0]}")
    log(f"window {win.seconds:.3f} s, {win.units} units, "
        f"reference automaton {json.dumps(geo)}")
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    want = loop.want(ref, dep, op, texts,
                     sorted({c.doc for c in win.calls}))
    checks = check.compare(win.calls, want, op.same)
    log(f"reference: {time.perf_counter() - t1:.3f} s, "
        f"{len(win.calls)} answers compared")
    result = {
        "correct": check.passed(checks),
        "attempted": len(win.calls),
        "failed": sum(c.error is not None for c in win.calls)
        + checks["wrong_answers"]["value"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else dev.type,
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result
