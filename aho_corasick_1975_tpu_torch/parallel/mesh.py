"""The device mesh of the port: an ordered 1-D list of shards.

The port of ``parallel/mesh.py``. The corpus is sharded data-parallel along
one "data" axis and the automaton's tables are replicated, one copy per
distinct device (models/snapshot.py). A shard is a place where one slice of
the corpus is scanned: a device, owned by one process.

* Within a process the shards are devices of that process, in order. A
  device may appear more than once: each appearance is a logical shard of
  its own, scanned one after another on that device. This is the
  counterpart of XLA's virtual host devices, on which every JAX mesh test
  runs (``--xla_force_host_platform_device_count``): the CPU tests build 8
  CPU shards (``make_mesh(devices=["cpu"] * 8)``) and one card can hold 4
  (``["cuda:0"] * 4``).
* Across processes (``init_distributed``, then ``make_mesh`` in every
  process) the mesh is every process's shards in rank order. The halo
  handoff between the last shard of rank r and the first of rank r+1 is a
  ``torch.distributed`` send and receive, and results come back to every
  process through ``all_gather``: NCCL for CUDA meshes, gloo for CPU
  meshes. NCCL refuses two ranks on one GPU, so one card runs one rank and
  its logical shards.

``data_sharded`` places a host array or a tensor as one tensor per shard,
on the shard's device (``jax.device_put(x, data_sharded(mesh))``): the form
in which a caller hands ``ShardedScanner`` a resident corpus or a resident
[L, B] batch. ``replicated`` places one copy per distinct device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


class Mesh:
    """An ordered 1-D mesh: ``devices[i]`` is shard i's device and
    ``ranks[i]`` the process that owns it. ``shape`` maps the axis name to
    the number of shards, as a JAX mesh's does. ``distributed``: the mesh
    spans a ``torch.distributed`` process group (of one or more
    processes), and its results travel through the group's collectives."""

    def __init__(self, devices: Sequence, ranks: Sequence[int],
                 axis_name: str = DATA_AXIS, distributed: bool = False):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.ranks: List[int] = [int(r) for r in ranks]
        self.axis_name = axis_name
        self.distributed = distributed
        self.rank = dist.get_rank() if distributed else 0
        self.world_size = dist.get_world_size() if distributed else 1
        self.local = [i for i, r in enumerate(self.ranks) if r == self.rank]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}

    def local_devices(self) -> List[torch.device]:
        """The distinct devices of this process's shards, in order."""
        out: List[torch.device] = []
        for i in self.local:
            if self.devices[i] not in out:
                out.append(self.devices[i])
        return out

    def comm_device(self) -> torch.device:
        """Where this process's collective buffers live: its current CUDA
        device under NCCL, else the CPU."""
        if self.distributed and dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def __repr__(self) -> str:
        return (f"Mesh({self.size} shards on {[str(d) for d in self.devices]}"
                f", ranks {self.ranks}, axis {self.axis_name!r})")


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` shards (default:
    all).

    ``devices``: this process's shards, in order; a device may repeat
    (logical shards). Default: every CUDA device of this process, or under
    an initialised process group the process's current CUDA device (one
    card per rank, as torchrun runs it). Under a process group every
    process must call this, and the mesh is every process's shards in rank
    order. Raises ValueError when ``n_devices`` exceeds the shards present
    or no CUDA device is present and none were named: the mesh never falls
    back to the CPU by itself."""
    distributed = dist.is_available() and dist.is_initialized()
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise ValueError("no CUDA device is present; name the mesh's "
                             "devices (e.g. devices=['cpu'] * 8)")
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if distributed else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    local = [str(torch.device(d)) for d in devices]
    if distributed:
        per_rank: List[Optional[List[str]]] = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, local)
    else:
        per_rank = [local]
    all_devices = [d for shards in per_rank for d in shards]
    ranks = [r for r, shards in enumerate(per_rank) for _ in shards]
    if n_devices is not None:
        if n_devices > len(all_devices):
            raise ValueError(f"requested {n_devices} devices, only "
                             f"{len(all_devices)} present")
        all_devices, ranks = all_devices[:n_devices], ranks[:n_devices]
    if not all_devices:
        raise ValueError("the mesh has no devices")
    return Mesh(all_devices, ranks, axis_name, distributed)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Start the ``torch.distributed`` process group the mesh's
    collectives run on; call once in every process, before make_mesh().

    ``coordinator_address`` "host:port" (or "tcp://host:port") with
    ``num_processes`` and ``process_id``; without it, torchrun's env://
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). ``backend``:
    default NCCL where CUDA is present, else gloo. Under NCCL the current
    CUDA device becomes LOCAL_RANK's (else the rank's) modulo the devices
    present."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        addr = coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
    else:
        init_method = "env://"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


class ShardedTensor:
    """A tensor split along ``axis`` into ``mesh.size`` equal shards, of
    which this process holds its own: ``shards[i]`` on ``mesh.devices[i]``
    for every i in ``mesh.local``. ``shape`` and ``dtype`` are the whole
    tensor's."""

    def __init__(self, mesh: Mesh, shards: Dict[int, torch.Tensor],
                 shape, dtype: torch.dtype, axis: int = 0):
        self.mesh = mesh
        self.shards = shards
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.axis = axis

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"axis={self.axis}, {self.mesh.size} shards)")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def data_sharded(mesh: Mesh, x, axis: int = 0) -> ShardedTensor:
    """Place ``x`` (a host array or a tensor, the same whole array in
    every process) as one contiguous tensor per shard along ``axis``, each
    on its shard's device; this process keeps its own shards. The axis'
    length must divide by the mesh size."""
    t = _as_tensor(x)
    n = t.shape[axis]
    if n % mesh.size:
        raise ValueError(f"length {n} along axis {axis} is not divisible by "
                         f"the {mesh.size}-shard mesh")
    per = n // mesh.size
    shards = {i: t.narrow(axis, i * per, per).to(mesh.devices[i],
                                                 copy=True).contiguous()
              for i in mesh.local}
    return ShardedTensor(mesh, shards, t.shape, t.dtype, axis)


def replicated(mesh: Mesh, x) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``x`` on each distinct device of this process's
    shards, by device."""
    t = _as_tensor(x)
    return {d: t.to(d, copy=True) for d in mesh.local_devices()}
