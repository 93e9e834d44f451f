"""Runtime configuration: the port of ``utils/config.py``.

Every knob is a runtime dataclass: construction mode, backend choice, scan
geometry, k-gram table budget and mesh shape, one object to pass around,
log and serialise with an experiment. ``ScanConfig.device`` is the port's
addition: DenseScanner takes the device it runs on (default "cuda").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class ScanConfig:
    """Scan geometry of DenseScanner (models/scanner.py)."""

    n_streams: Any = "auto"         # parallel block streams on the device
    step_k: Any = "auto"            # symbols advanced per gather (int|'auto')
    step_budget_bytes: int = 128 * 1024 * 1024
    halo: Optional[int] = None      # override warm-up length (default D-1)
    engine: str = "auto"            # gather | mxu | hybrid | auto
    prefilter: str = "off"          # off | auto | on (sparse corpora)
    device_encode: bool = True      # raw upload + in-kernel vocab encode
    calibrate: bool = False         # measured engine choice (ops/autotune)
    device: str = "cuda"            # where DenseScanner's tables and scans live


@dataclass
class MeshConfig:
    """Data-parallel mesh shape (parallel/)."""

    n_devices: Optional[int] = None  # None = every shard make_mesh finds
    axis_name: str = "data"
    n_streams_per_device: int = 256
    engine: str = "auto"
    prefilter: str = "off"


@dataclass
class MachineConfig:
    """Everything needed to build a machine and its scanners
    reproducibly."""

    incremental: bool = True        # Meyer-1985 vs AC75 (runtime, not -D)
    backend: str = "auto"           # auto | native | python
    key_fn: Optional[Callable] = None
    scan: ScanConfig = field(default_factory=ScanConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def build_machine(self):
        from ..models.machine import Machine
        return Machine(key_fn=self.key_fn, incremental=self.incremental,
                       backend=self.backend)

    def build_scanner(self, machine):
        return machine.scanner(n_streams=self.scan.n_streams,
                               halo=self.scan.halo,
                               step_k=self.scan.step_k,
                               step_budget_bytes=self.scan.step_budget_bytes,
                               engine=self.scan.engine,
                               prefilter=self.scan.prefilter,
                               device_encode=self.scan.device_encode,
                               calibrate=self.scan.calibrate,
                               device=self.scan.device)

    def build_sharded_scanner(self, machine, mesh=None):
        """A ShardedScanner on ``mesh``, by default ``make_mesh`` over
        ``mesh.n_devices`` CUDA devices."""
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_scan import ShardedScanner
        if mesh is None:
            mesh = make_mesh(self.mesh.n_devices, axis_name=self.mesh.axis_name)
        return ShardedScanner(
            machine, mesh, n_streams_per_device=self.mesh.n_streams_per_device,
            axis_name=self.mesh.axis_name,
            step_k=self.scan.step_k,
            step_budget_bytes=self.scan.step_budget_bytes,
            engine=self.mesh.engine, prefilter=self.mesh.prefilter,
            device_encode=self.scan.device_encode,
            calibrate=self.scan.calibrate)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["key_fn"] = getattr(self.key_fn, "__qualname__", None) \
            if self.key_fn else None
        return json.dumps(d)
