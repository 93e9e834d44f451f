"""The benchmark's specification, and everything in it found by name:
``BENCHMARK.json`` at the checkout's root; a configuration's file and its
generator beside it (``configs/<config>.json``, ``configs/<config>.py``); a
traffic mix (``traffic/<traffic>.json``, and the loops and operations of
its own, where it has any, in ``traffic/<traffic>.py``); a metric's reader
(``metrics/<metric>.py``). A cell, a mix or a metric is added by adding
files and entries, never by editing a file that is there."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
OUT_DIR = ROOT / "build" / "scanbench"   # run outputs, inside the checkout


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclass
class Cell:
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def generator(self) -> ModuleType:
        """The configuration's generator, beside its file."""
        path = ROOT / self.config_entry["file"]
        return load_module(path.with_name(self.config["generator"]),
                           f"scanbench_config_{self.config['name']}")

    def traffic_module(self) -> Optional[ModuleType]:
        """The mix's own code (``traffic/<traffic>.py``), or None."""
        name = self.workload["traffic"]
        path = BENCH_DIR / "traffic" / f"{name}.py"
        if not path.exists():
            return None
        return load_module(path, "scanbench_traffic_"
                           + name.replace(".", "_").replace("-", "_"))

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of ``bench``'s workloads."""
    return make_cell(bench, _by_name(bench["workloads"], workload,
                                     "workload"))


def make_cell(bench: dict, workload: dict) -> Cell:
    """The cell of a workload entry (name, config, traffic, chips): its
    configuration from ``bench``, its mix file, and the metrics that apply
    to its name."""
    c = _by_name(bench["configs"], workload["config"], "config")
    with open(ROOT / c["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{workload['traffic']}.json") as f:
        traffic = json.load(f)
    name = workload["name"]
    return Cell(workload, c, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str) -> ModuleType:
    """The reader of ``metric``: ``metrics/<metric>.py``, whose
    ``read(run)`` gives the number, or None where the run has nothing to
    read."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "scanbench_metric_" + metric.replace(".", "_"))
