"""Multi-device data-parallel scanning: per-shard kernels, a halo handoff at
shard edges, and per-stream totals gathered for an int64 host sum.

The port of ``parallel/sharded_scan.py``. The corpus is cut into
``mesh.size`` equal shards (parallel/mesh.py); the tables are replicated on
every distinct device of the mesh (models/snapshot.py, ``packed_only``, as
the JAX mesh scanner's). A match can span a shard edge, so each shard runs
the last ``halo`` symbols of its left neighbour first, from the root, as
warm-up (ops/blocking.py's exactness argument); shard 0 runs the session
head, or OOV. Each JAX ``make_sharded_*`` factory becomes a call, per
shard, of the port's op that launches the kernel of the single-device
path:

* count: K3 (packed k-gram table), K1 (``step_k=1``), K10 (``engine=
  "mxu"``), K11 (``engine="hybrid"``; K3 alone on shards of fewer than 16
  streams, as in JAX); the sparse prefilter's counts K7;
* scan_states: K2; find_matches: K4 and the plain refinement
  (ops/hits.py), or K8 (stream form without a packed table or with the
  MXU engine, window forms for the prefilter); count_many: K5, K6 or K10's
  batch form over the shard's columns.

The halo handoff (JAX ``_right_shift_halo``, a ``lax.ppermute``): for a
host input every process holds the whole corpus (JAX's multi-controller
contract), so each shard's halo is staged with it from host memory. A
resident corpus (a ``ShardedTensor`` of letter ids, or a tensor placed
here) takes the device handoff: within a process a slice copied to the
next shard's device, across processes a ``torch.distributed`` send from
rank r to rank r+1. Results (per-stream int32 totals, hit buffers, states)
come back through ``all_gather`` (``lax.all_gather``) in every process, and
totals are summed on the host in int64: the two-level reduction.

Each shard keeps the JAX per-shard geometry: ``B = min(n_streams_per_device,
max(1, Tl // 64))`` streams of ``L = ceil(Tl / B)`` symbols, and for the
k-gram kernels ``_stepped_geometry``.

Unlike the JAX mesh scanner, which trusts the caller, resident ids and
[L, B] batches are checked against [0, V) and raise ValueError (ROADMAP
C3): a CUDA kernel would read out of bounds where XLA clamps.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.results import MatchSet
from ..models.scanner import (DenseScanner, StreamSession, _guard_pos32,
                              bind_scanner, calibrate_scanner, encode_signs,
                              raw_lut_entry, raw_stream_for)
from ..models.snapshot import DeviceSnapshot
from ..ops import (build, hits, multistep, scan_dense, scan_hybrid,
                   scan_mxu, sparse)
from ..ops.decode import decode_matches_arrays, expand_hits_arrays
from .mesh import DATA_AXIS, Mesh, ShardedTensor, data_sharded

# Auto retrieval falls back to the full per-position decode only when the
# gathered hit buffers would both exceed the decode's own footprint and
# this absolute floor (the JAX package's rule).
_AUTO_DECODE_FLOOR_BYTES = 64 << 20


def _stepped_geometry(Tl: int, k: int, n_streams_per_device: int):
    """(B, L) of a shard of Tl symbols for the k-gram kernels: L a
    multiple of 64*k."""
    unit = 64 * k
    B = min(n_streams_per_device, max(1, Tl // unit))
    return B, -(-(-(-Tl // B)) // unit) * unit


def _dense_geometry(Tl: int, n_streams_per_device: int):
    """(B, L) of a shard of Tl symbols for the 1-char and MXU kernels."""
    B = min(n_streams_per_device, max(1, Tl // 64))
    return B, -(-Tl // B)


def _pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _all_gather(mesh: Mesh, local: Dict[int, torch.Tensor],
                dtype: torch.dtype) -> list:
    """Every shard's 1-D tensor as a host array, in shard order, in every
    process (``lax.all_gather``): over the process group when the mesh has
    one (sizes first, then the tensors padded to the longest), else
    copied from this process's devices."""
    if not mesh.distributed:
        return [local[i].to(dtype).cpu().numpy() for i in range(mesh.size)]
    dev = mesh.comm_device()
    owned = [[i for i, r in enumerate(mesh.ranks) if r == q]
             for q in range(mesh.world_size)]
    slots = max(1, max(len(o) for o in owned))
    sizes = np.zeros(slots, np.int64)
    for j, i in enumerate(mesh.local):
        sizes[j] = local[i].numel()
    sizes = torch.from_numpy(sizes).to(dev)
    all_sizes = [torch.empty_like(sizes) for _ in range(mesh.world_size)]
    dist.all_gather(all_sizes, sizes)
    all_sizes = torch.stack(all_sizes).cpu().numpy()
    buf = torch.zeros((slots, max(1, int(all_sizes.max()))), dtype=dtype,
                      device=dev)
    for j, i in enumerate(mesh.local):
        buf[j, :local[i].numel()] = local[i].reshape(-1).to(dev, dtype)
    bufs = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(bufs, buf)
    out = [None] * mesh.size
    for q, shards in enumerate(owned):
        host = bufs[q].cpu().numpy()
        for j, i in enumerate(shards):
            out[i] = host[j, :all_sizes[q][j]]
    return out


def _tail(ids: torch.Tensor, halo: int) -> torch.Tensor:
    """The last ``halo`` ids of a shard as int32, OOV in front where the
    shard is shorter (JAX ``_right_shift_halo``)."""
    tail = ids[-halo:].to(torch.int32)
    if tail.numel() < halo:
        tail = torch.cat([torch.zeros(halo - tail.numel(), dtype=torch.int32,
                                      device=ids.device), tail])
    return tail


def _left_halos(mesh: Mesh, shards: Dict[int, torch.Tensor], halo: int,
                head: Optional[np.ndarray]) -> Dict[int, torch.Tensor]:
    """Each local shard's left halo on its device: the tail of shard i-1
    (a copy within the process, a send from rank r to rank r+1 across
    processes), ``head`` or OOV for shard 0."""
    out: Dict[int, torch.Tensor] = {}
    ops, recvs = [], {}
    comm = mesh.comm_device()
    for i in mesh.local:
        dev = mesh.devices[i]
        if i == 0:
            first = head if head is not None else np.zeros(halo, np.int32)
            out[i] = torch.from_numpy(first).to(dev)
        elif mesh.ranks[i - 1] == mesh.rank:
            out[i] = _tail(shards[i - 1], halo).to(dev)
        else:
            recvs[i] = torch.empty(halo, dtype=torch.int32, device=comm)
            ops.append(dist.P2POp(dist.irecv, recvs[i], mesh.ranks[i - 1]))
        if i + 1 < mesh.size and mesh.ranks[i + 1] != mesh.rank:
            ops.append(dist.P2POp(dist.isend, _tail(shards[i], halo).to(comm),
                                  mesh.ranks[i + 1]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, buf in recvs.items():
        out[i] = buf.to(mesh.devices[i])
    return out


class ShardedScanner:
    """Mesh-wide scanner over a machine snapshot: the multi-device sibling
    of models.scanner.DenseScanner (JAX ``ShardedScanner``)."""

    def __init__(self, machine, mesh: Mesh, n_streams_per_device: int = 256,
                 axis_name: str = DATA_AXIS, tables=None,
                 step_k: "int | str" = "auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 engine: str = "auto", prefilter: str = "off",
                 device_encode: bool = True,
                 device_encode_max_cp: int = 1024,
                 calibrate: bool = False):
        """The JAX mesh scanner's arguments. ``engine``: "gather", "mxu",
        "hybrid" (each raises ValueError where the automaton does not fit
        it, as DenseScanner's) or "auto", which is "gather" unless
        ``calibrate`` measures the engines on this mesh. ``prefilter``:
        "off" | "auto" | "on", the sparse prefilter, per shard. This
        process must own at least one shard of ``mesh``."""
        if engine not in ("auto", "gather", "mxu", "hybrid"):
            raise ValueError(f"unknown engine {engine!r}")
        if prefilter not in ("off", "auto", "on"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}")
        if not mesh.local:
            raise ValueError("this process owns no shard of the mesh")
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        self._engine = engine
        self._prefilter = prefilter
        self.machine = machine
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_dev = mesh.shape[axis_name]
        devices = mesh.local_devices()
        self._snap = DeviceSnapshot(
            tables if tables is not None else machine.compile(),
            step_k=step_k, step_budget_bytes=step_budget_bytes,
            device=devices[0], packed_only=True, devices=devices[1:])
        self.halo = max(self.tables.max_depth - 1, 0)
        self._n_streams_per_device = int(n_streams_per_device)
        self._device_encode = bool(device_encode)
        self._device_encode_max_cp = int(device_encode_max_cp)
        self._lut_cache: dict = {}
        self.stats: dict = {}
        # Launches per shard and kernel (entry or "entry/form", as in
        # ops/build.py), so that a run can show every shard went through
        # its kernels; clear it to start a new tally.
        self.shard_launches: Dict[int, Dict[str, int]] = {}
        self._engine_planes = None
        # One lock for scans, refresh() and recalibrate(): a rebind never
        # interleaves with a scan's reads of the tables.
        self._dispatch = threading.RLock()
        self._bind()
        if calibrate and engine == "auto":
            self._calibrate_engine()

    # -- engine and snapshot -------------------------------------------------

    def recalibrate(self) -> str:
        """Measure the engines on this mesh again now, ignoring the cached
        choice, and bind the winner; returns its name."""
        with self._dispatch:
            self._calibrate_engine(force=True)
            return self._engine

    def _calibrate_engine(self, force: bool = False) -> None:
        """``calibrate_scanner`` on this mesh (the probe rebinds through
        ``_bind`` as for DenseScanner), with the mesh size in the cache
        key. Under a process group rank 0's choice is taken by every
        process."""
        calibrate_scanner(self, self.mesh.local_devices()[0], force,
                          f"|mesh{self.n_dev}", self._agree)

    def _agree(self, choice: str) -> str:
        if self.mesh.distributed:
            box = [choice]
            dist.broadcast_object_list(box, src=0)
            choice = box[0]
        return choice

    @property
    def tables(self):
        return self._snap.tables

    @property
    def V(self) -> int:
        return self._snap.V

    @property
    def step_k(self) -> int:
        return self._snap.step_k

    @property
    def _stepped(self):
        return self._snap.stepped

    @property
    def _two_table(self) -> bool:
        return False  # the mesh snapshot is packed_only

    @property
    def version(self) -> int:
        return self.tables.version

    def _tab(self, i: int) -> dict:
        """The tables on shard i's device."""
        return self._snap.replica(self.mesh.devices[i])

    _dense_fields = DenseScanner._dense_fields

    def _replicate(self, a: np.ndarray) -> Dict[torch.device, torch.Tensor]:
        return {d: self._snap.place(a, d) for d in self._snap.devices}

    def _bind(self) -> None:
        """``bind_scanner`` (JAX ``_bind_kernels``) with the planes and
        their kernels' copy on every replica's device, by device. The one
        rebind of ``__init__``, ``refresh()``, calibration and
        ``autotune.probe``."""
        bind_scanner(self, self._replicate)

    def refresh(self) -> bool:
        """Bring the replicated snapshot up to the machine's dictionary
        (JAX ``ShardedScanner.refresh``): rows and cells written into every
        device's replica in place (True), or a full rebuild (False); a
        keyword longer than the halo grows it to a multiple of 8."""
        with self._dispatch:
            new = self.machine.compile()
            if new.version == self.tables.version:
                return True
            status = self._snap.refresh(new)
            need = max(new.max_depth - 1, 0)
            if need > self.halo:
                self.halo = -(-need // 8) * 8
            self._bind()
            return not status.startswith("rebuild")

    # -- encoding and staging ----------------------------------------------

    def encode(self, signs) -> np.ndarray:
        """Map host signs to dense letter ids (OOV -> 0); int32 arrays pass
        through as pre-encoded ids, checked against [0, V)."""
        return encode_signs(self.machine, signs, self.V)

    def _get_lut(self, kind: str):
        return raw_lut_entry(self.machine, self.V, self.tables, kind,
                             self._device_encode_max_cp, self._lut_cache,
                             self._replicate)

    def _raw_stream(self, signs):
        if not self._device_encode:
            return None
        return raw_stream_for(self.machine, signs, self._get_lut)

    def _head_arr(self, head, halo: int) -> Optional[np.ndarray]:
        """The session carry as [halo] letter ids, OOV in front where it
        is shorter; None without one. Checked against [0, V)."""
        if head is None or halo == 0 or len(head) == 0:
            return None
        tail = np.asarray(head, np.int32)[-halo:]
        if int(tail.min()) < 0 or int(tail.max()) >= self.V:
            raise ValueError(f"head letter ids fall outside [0, {self.V})")
        out = np.zeros(halo, np.int32)
        out[halo - len(tail):] = tail
        return out

    def _guard_acc(self, T_padded: int) -> None:
        """The int32 per-stream accumulators of the first reduction level:
        a shard's stream of L symbols holds at most L * max(nb_outputs)
        matches."""
        _, L = _dense_geometry(T_padded // self.n_dev,
                               self._n_streams_per_device)
        if L * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a per-device stream of {L} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow the "
                "int32 per-stream accumulator; chunk the input with "
                "scanner.session() or raise n_streams_per_device")

    def _min_shard(self) -> int:
        return max(self.halo, self._halo_sym, 1)

    def _padded(self, arr: np.ndarray) -> np.ndarray:
        """A host array padded with 0 (OOV) to n_dev equal shards of at
        least ``_min_shard()`` symbols."""
        T = len(arr)
        Tp = max(-(-T // self.n_dev), self._min_shard()) * self.n_dev
        if Tp != T:
            arr = np.concatenate([arr, np.zeros(Tp - T, arr.dtype)])
        return arr

    def _check_range(self, sharded: ShardedTensor) -> None:
        """Resident letter ids within [0, V); every process sees every
        shard's extremes, so all raise together."""
        ext = {i: torch.stack([t.min(), t.max()]).to(torch.int64)
               for i, t in sharded.shards.items()}
        both = np.concatenate(_all_gather(self.mesh, ext, torch.int64))
        if int(both.min()) < 0 or int(both.max()) >= self.V:
            raise ValueError(
                f"device-resident letter ids fall outside [0, {self.V})")

    def _resident(self, ids) -> Optional[ShardedTensor]:
        """A 1-D resident corpus of letter ids (a ``ShardedTensor`` of this
        mesh, or a tensor, placed here) as an int32 ShardedTensor,
        validated; None when empty."""
        if ids.dtype.is_floating_point or ids.dtype.is_complex \
                or ids.dtype == torch.bool:
            raise ValueError("device-array input must be integer letter ids "
                             f"(got dtype {ids.dtype})")
        if len(ids.shape) != 1:
            raise ValueError("a resident corpus must be 1-D letter ids (got "
                             f"shape {tuple(ids.shape)})")
        T = int(ids.shape[0])
        if T == 0:
            return None
        if T % self.n_dev or T // self.n_dev < self._min_shard():
            raise ValueError(
                f"device-resident mesh input length {T} must be divisible "
                f"by the {self.n_dev}-device mesh with at least "
                f"{self._min_shard()} symbols per shard; pad with OOV id 0")
        if not isinstance(ids, ShardedTensor):
            ids = data_sharded(self.mesh, ids)
        elif ids.mesh is not self.mesh and ids.mesh.devices != \
                self.mesh.devices:
            raise ValueError("the ShardedTensor is placed on another mesh")
        if ids.dtype != torch.int32:
            ids = ShardedTensor(self.mesh, {i: t.to(torch.int32) for i, t in
                                            ids.shards.items()},
                                ids.shape, torch.int32)
        self._check_range(ids)
        return ids

    def _source(self, signs):
        """(kind, data, T) for a scan over letter ids: ("dev",
        ShardedTensor, T) for a resident corpus, ("ids", padded host ids,
        T) for host signs encoded here (JAX ``_placed_for``); None when
        empty."""
        if isinstance(signs, (ShardedTensor, torch.Tensor)):
            src = self._resident(signs)
            return None if src is None else ("dev", src, src.shape[0])
        ids = self.encode(signs)
        if len(ids) == 0:
            return None
        return "ids", self._padded(ids), len(ids)

    def _shard_len(self, src) -> int:
        kind, data = src[0], src[1]
        n = data.shape[0] if kind == "dev" else len(
            data[0] if kind == "raw" else data)
        return n // self.n_dev

    def _shard_exts(self, src, halo: int, total: int, head):
        """{shard: (ext, lut, head_ids)} on each local shard's device: ext
        [halo + total] = the shard's left halo, its Tl symbols, OOV pad
        (JAX ``concatenate([left, ids_local, pad])``). Raw symbols carry
        their LUT, and the left halo as letter ids in ``head_ids`` (encoded
        on the host through the LUT, clamped as the kernel clamps)."""
        kind, data = src[0], src[1]
        mesh, Tl = self.mesh, self._shard_len(src)
        head = self._head_arr(head, halo)
        out = {}
        if kind == "dev":
            if halo:
                lefts = _left_halos(mesh, data.shards, halo, head)
            for i in mesh.local:
                dev = mesh.devices[i]
                parts = [data.shards[i], torch.zeros(
                    total - Tl, dtype=torch.int32, device=dev)]
                if halo:
                    parts.insert(0, lefts[i])
                out[i] = (torch.cat(parts), None, None)
            return out
        if kind == "raw":
            arr, ent = data
            lut_host, n_lut = ent[3], ent[1]
        else:
            arr = data
        for i in mesh.local:
            dev = mesh.devices[i]
            if i == 0 or not halo:
                left = head if head is not None else np.zeros(halo, np.int32)
            else:
                left = arr[i * Tl - halo:i * Tl]
                if kind == "raw":
                    left = lut_host[np.minimum(left.astype(np.int64),
                                               n_lut - 1)]
            buf = np.zeros(halo + total, arr.dtype)
            buf[halo:halo + Tl] = arr[i * Tl:(i + 1) * Tl]
            if kind == "raw":
                out[i] = (self._snap.place(buf, dev), ent[0][dev],
                          self._snap.place(np.asarray(left, np.int32), dev))
            else:
                buf[:halo] = left
                out[i] = (self._snap.place(buf, dev), None, None)
        return out

    def _on_shards(self, fn, *per_shard) -> dict:
        """{shard: fn(i, *(d[i] for d in per_shard))} over the local shards,
        each call's kernel launches tallied in ``shard_launches[i]``."""
        out = {}
        for i in self.mesh.local:
            before = {**build.launches, **build.form_launches}
            out[i] = fn(i, *(d[i] for d in per_shard))
            tally = self.shard_launches.setdefault(i, {})
            for name, n in {**build.launches, **build.form_launches}.items():
                if n > before.get(name, 0):
                    tally[name] = tally.get(name, 0) + n - before.get(name, 0)
        return out

    def _gather(self, local: dict, dtype=torch.int32) -> list:
        return _all_gather(self.mesh, local, dtype)

    def _total(self, per: dict) -> int:
        """int64 host sum of the shards' per-stream int32 totals."""
        return int(sum(int(a.sum(dtype=np.int64))
                       for a in self._gather(per)))

    # -- count ----------------------------------------------------------------

    def count(self, signs, head=None) -> int:
        """Total keyword occurrences across the sharded stream; ``head``:
        the session carry (the previous chunk's last letter ids)."""
        with self._dispatch:
            return self._count_locked(signs, head)

    def _count_locked(self, signs, head) -> int:
        """JAX ``_count_locked``: a resident corpus takes the device path;
        raw symbols the raw filter and elision, whose "dense" verdict goes
        to the raw engines; host ids the host filter; then the engines."""
        if isinstance(signs, (ShardedTensor, torch.Tensor)):
            return self._count_device(signs, head)
        if not len(signs):
            return 0
        dense_verdict = False
        raw = self._raw_stream(signs)
        if raw is not None:
            if self._prefilter != "off":
                n = self._sparse_count_raw(raw[0], raw[1], head)
                if isinstance(n, int):
                    return n
                dense_verdict = n == "dense"
            if self._prefilter == "off" or dense_verdict:
                return self._count_stream(
                    ("raw", (self._padded(raw[0]), raw[1]), len(raw[0])),
                    head)
        ids = self.encode(signs)
        if len(ids) == 0:
            return 0
        if self._prefilter != "off":
            n = self._sparse_count(ids, head)
            if n is not None:
                return n
        return self._count_stream(("ids", self._padded(ids), len(ids)), head)

    def _count_device(self, signs, head) -> int:
        src = self._source(signs)
        if src is None:
            return 0
        if self._prefilter != "off":
            n = self._sparse_count_device(src, head)
            if n is not None:
                return n
        return self._count_stream(src, head)

    def _count_engine(self):
        """(halo, geometry(Tl) -> (B, L), count(i, B, L, ext, lut,
        head_ids) -> per-stream int32 totals [B]) of the bound engine: K10
        for "mxu", K11 for "hybrid" (K3 on shards under 16 streams), K3
        with the packed table, else K1."""
        st, nspd = self._stepped, self._n_streams_per_device
        if self._mxu is not None:
            planes, cbits, n_planes, _ = self._mxu

            def count(i, B, L, ext, lut, head_ids):
                return scan_mxu.mxu_count(
                    planes[self.mesh.devices[i]], self.V, cbits, n_planes,
                    self.halo, B, L, ext, lut, head_ids,
                    planes_t=self._planes_t[self.mesh.devices[i]])
            return self.halo, lambda Tl: _dense_geometry(Tl, nspd), count
        if st is not None:
            def count(i, B, L, ext, lut, head_ids):
                packed = self._tab(i)["packed"]
                B2 = 0
                if self._hybrid is not None and B >= 16:
                    B2 = scan_hybrid.mxu_cols(B, self._hybrid[3])
                if B2 == 0:
                    return multistep.stepped_count(
                        packed, st.V, st.k, st.count_bits, self._halo_steps,
                        B, L, ext, lut, head_ids, warm_steps=self._warm_steps)
                planes, cbm, n_planes, _ = self._hybrid
                return scan_hybrid.hybrid_count(
                    packed, planes[self.mesh.devices[i]], st.V, st.k,
                    st.count_bits, self._halo_steps, n_planes, cbm, B - B2,
                    B, L, ext, lut, head_ids,
                    planes_t=self._planes_t[self.mesh.devices[i]],
                    warm_steps=self._warm_steps)
            return (self._halo_sym,
                    lambda Tl: _stepped_geometry(Tl, st.k, nspd), count)

        def count(i, B, L, ext, lut, head_ids):
            tab = self._tab(i)
            return scan_dense.dense_count(tab["dflat"], tab["nb_out"], self.V,
                                          self.halo, B, L, ext, lut, head_ids,
                                          **self._dense_fields())
        return self.halo, lambda Tl: _dense_geometry(Tl, nspd), count

    def _count_stream(self, src, head) -> int:
        """The engine's count over every shard's stream (JAX
        ``_count_placed`` and ``_count_raw``)."""
        Tl = self._shard_len(src)
        self._guard_acc(Tl * self.n_dev)
        halo, geometry, count = self._count_engine()
        B, L = geometry(Tl)
        exts = self._shard_exts(src, halo, B * L, head)
        return self._total(self._on_shards(
            lambda i, e: count(i, B, L, *e), exts))

    # -- sparse prefilter: count ---------------------------------------------

    def _sparse_geometry(self):
        """(use the packed k-gram windows, k, halo, L_blk) of the prefilter's
        host-side count (JAX ``use_stepped``)."""
        st = self._stepped
        if self._mxu is None and st is not None:
            return True, st.k, self._halo_sym, 128 * st.k
        return False, 1, self.halo, 128

    def _window_count(self, srcs: dict, idxs: Optional[dict] = None) -> int:
        """K7 over each shard's windows: ``srcs[i]`` its index-list stream
        with ``idxs[i]``, or its elided windows; the int64 total."""
        stepped, k, _, L_blk = self._sparse_geometry()
        st = self._stepped

        def count(i, src):
            idx = None if idxs is None else idxs[i]
            tab = self._tab(i)
            if stepped:
                return sparse.sparse_count_stepped(
                    tab["packed"], st.V, k, st.count_bits, self._halo_steps,
                    L_blk, src, idx)
            return sparse.sparse_count(tab["dflat"], tab["nb_out"], self.V,
                                       self.halo, L_blk, src, idx,
                                       **self._dense_fields())
        return self._total(self._on_shards(count, srcs))

    def _elided_shards(self, tm: np.ndarray, idx: Optional[np.ndarray]):
        """Host-elided windows [rows, cap] split along the window axis,
        cap/n_dev columns a shard on its device, with their block indices;
        windows carry their own halo, so no handoff."""
        w = tm.shape[1] // self.n_dev
        place = self._snap.place
        srcs = {i: place(np.ascontiguousarray(tm[:, i * w:(i + 1) * w]),
                         self.mesh.devices[i]) for i in self.mesh.local}
        idxs = None if idx is None else {
            i: place(idx[i * w:(i + 1) * w].astype(np.int32),
                     self.mesh.devices[i]) for i in self.mesh.local}
        return srcs, idxs

    def _sparse_count_raw(self, raw: np.ndarray, ent, head):
        """Raw-input dead-block elision (JAX ``_sparse_count_raw``): the
        live windows are gathered and encoded on the host, columns padded
        to a mesh multiple, and counted sharded along the window axis. An
        int, "dense" (the "auto" gate: the raw engines, no re-filter) or
        None (the id path decides)."""
        lut_host, n_lut = ent[3], ent[1]
        _, _, halo, L_blk = self._sparse_geometry()
        verdict, live, n_live, nB_real = sparse.raw_elision_plan(
            raw, lut_host, n_lut, self._prefilter, halo, L_blk)
        if live is not None:
            self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if verdict == "zero":
            return 0
        if verdict in ("dense", "na"):
            return "dense" if verdict == "dense" else None
        tm, _ = sparse.elide_windows(raw, (lut_host, n_lut), len(raw), live,
                                     n_live, head, halo, L_blk, nB_real,
                                     pad_cols_to=self.n_dev)
        if (halo + L_blk) * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError("window accumulator could overflow int32")
        n = self._window_count(self._elided_shards(tm, None)[0])
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return n

    def _host_blocks(self, ids: np.ndarray, L_blk: int):
        """The host filter per shard (JAX ``_sparse_count``): (ids padded
        to n_dev * nB_loc blocks, nB_loc a power of two, live [n_dev,
        nB_loc], n_live per shard, nB_real)."""
        T = len(ids)
        nB_real = -(-T // L_blk)
        nB_loc = _pow2(max(1, -(-T // (self.n_dev * L_blk))))
        Tp = self.n_dev * nB_loc * L_blk
        if Tp != T:
            ids = np.concatenate([ids, np.zeros(Tp - T, np.int32)])
        live = sparse.live_blocks(ids, L_blk).reshape(self.n_dev, nB_loc)
        n_live = live.sum(axis=1)
        self.stats["sparse_live_frac"] = int(n_live.sum()) / max(nB_real, 1)
        return ids, nB_loc, live, n_live, nB_real

    def _host_idx(self, live: np.ndarray, nB_loc: int, cap: int) -> dict:
        """Each shard's live blocks then pad slots at its spare all-OOV
        block nB_loc, int32 [cap] on its device."""
        out = {}
        for i in self.mesh.local:
            idx = np.full(cap, nB_loc, np.int32)
            w = np.flatnonzero(live[i])
            idx[:len(w)] = w
            out[i] = self._snap.place(idx, self.mesh.devices[i])
        return out

    def _declines(self, total_live: int, nB_real: int) -> bool:
        return self._prefilter == "auto" and total_live * 2 > nB_real

    def _sparse_count(self, ids: np.ndarray, head) -> Optional[int]:
        """Filter-then-verify over host ids: each shard scans only its live
        windows from its stream, halo from its left neighbour. None when
        the halo is wider than a block or the "auto" gate declines."""
        _, _, halo, L_blk = self._sparse_geometry()
        if halo > L_blk:
            return None
        ids, nB_loc, live, n_live, nB_real = self._host_blocks(ids, L_blk)
        total_live = int(n_live.sum())
        if total_live == 0:
            return 0  # all OOV: nothing can match, no launch
        if self._declines(total_live, nB_real):
            return None
        cap = max(8, _pow2(int(n_live.max())))
        exts = self._shard_exts(("ids", ids), halo, (nB_loc + 1) * L_blk,
                                head)
        return self._window_count({i: e[0] for i, e in exts.items()},
                                  self._host_idx(live, nB_loc, cap))

    def _device_blocks(self, src, head, halo: int, L_blk: int):
        """The device block filter per shard over a resident corpus (JAX
        ``make_sharded_block_filter``): (exts {i: ext [halo + (nB_loc+1) *
        L_blk]}, orders, n_live per shard gathered, nB_loc), or None when
        the shards are not whole blocks."""
        Tl = self._shard_len(src)
        if Tl % L_blk:
            return None
        nB_loc = Tl // L_blk
        exts = self._shard_exts(src, halo, (nB_loc + 1) * L_blk, head)
        filt = self._on_shards(lambda i, e: sparse.block_filter(
            e[0], nB_loc, L_blk, halo), exts)
        n_live = np.concatenate(self._gather({
            i: torch.tensor([f[1]]) for i, f in filt.items()}))
        nB_real = -(-src[2] // L_blk)
        self.stats["sparse_live_frac"] = int(n_live.sum()) / max(nB_real, 1)
        return exts, filt, n_live, nB_loc, nB_real

    def _sparse_count_device(self, src, head) -> Optional[int]:
        """Filter-then-verify over a resident corpus (JAX
        ``_sparse_count_device``): the block filter and K7 (1-char windows)
        on each shard's device. None when not applicable or declined."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        blocks = self._device_blocks(src, head, halo, L_blk)
        if blocks is None:
            return None
        exts, filt, n_live, nB_loc, nB_real = blocks
        if int(n_live.sum()) == 0:
            return 0
        if self._declines(int(n_live.sum()), nB_real):
            return None
        cap = min(nB_loc, max(8, _pow2(int(n_live.max()))))

        def count(i, e):
            tab = self._tab(i)
            idx = sparse.dev_idx(filt[i][0], filt[i][1], nB_loc, cap)
            return sparse.sparse_count(tab["dflat"], tab["nb_out"], self.V,
                                       halo, L_blk, e[0], idx,
                                       **self._dense_fields())
        return self._total(self._on_shards(count, exts))

    # -- states and retrieval ------------------------------------------------

    def scan_states(self, signs, head=None) -> np.ndarray:
        """states[t] after every symbol of the sharded stream: K2 on each
        shard, gathered in stream order."""
        with self._dispatch:
            src = self._source(signs)
            if src is None:
                return np.zeros(0, np.int32)
            Tl = self._shard_len(src)
            B, L = _dense_geometry(Tl, self._n_streams_per_device)
            exts = self._shard_exts(src, self.halo, B * L, head)
            per = self._on_shards(lambda i, e: scan_dense.dense_states(
                self._tab(i)["dflat"], self.V, self.halo, B, L, e[0],
                **self._dense_fields())[:Tl], exts)
            return np.concatenate(self._gather(per))[:src[2]]

    def session(self) -> StreamSession:
        """A chunked streaming session over the mesh, exact across chunk
        edges: the carry rides into shard 0's halo."""
        return StreamSession(self)

    def _empty(self) -> MatchSet:
        return MatchSet(self.machine, self.tables, np.zeros(0, np.int64),
                        np.zeros(0, np.int32), np.zeros(0, np.int32))

    def _matchset(self, positions: dict, states: dict, T: int,
                  offset: int) -> MatchSet:
        """The MatchSet of every shard's hits (absolute positions, -1 or
        past T dropped), in stream order."""
        pos = np.concatenate(self._gather(positions, torch.int64))
        sts = np.concatenate(self._gather(states, torch.int32))
        keep = (pos >= 0) & (pos < T)
        pos, sts = pos[keep], sts[keep]
        order = np.argsort(pos, kind="stable")
        ends, end_states, idx = expand_hits_arrays(pos[order], sts[order],
                                                   self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _check_hits(self, n_hit_pos: dict, max_hits: int,
                    at_least: str = "") -> None:
        """Raise, in every process alike, when a shard holds more hit
        positions than ``max_hits``."""
        most = int(np.concatenate(self._gather(n_hit_pos)).max())
        if most > max_hits:
            raise ValueError(
                f"a shard has {at_least}{most} matching positions, over "
                f"max_hits_per_shard={max_hits}")

    def find_matches(self, signs, offset: int = 0, head=None,
                     max_hits_per_shard: Optional[int] = None):
        """(event, Match) occurrences across the sharded stream as a
        ``MatchSet``, in the reference's order (JAX
        ``ShardedScanner.find_matches``).

        ``max_hits_per_shard``: bound each shard's hits, raising if a shard
        holds more matching positions. Without it the buffers size
        themselves in one corpus pass: K4 leaves each shard's emit array on
        its device, and the gathered per-shard counters size the
        refinement. A prefilter scanner retrieves through K8 over its live
        windows; engines without a packed table (or "mxu") through K8's
        stream form under a bound, else the full decode of K2's
        states."""
        with self._dispatch:
            return self._find_matches_locked(signs, offset, head,
                                             max_hits_per_shard)

    def _find_matches_locked(self, signs, offset, head, max_hits):
        key = None if max_hits is None else int(max_hits)
        resident = isinstance(signs, (ShardedTensor, torch.Tensor))
        if self._prefilter != "off" and len(signs):
            if resident:
                out = self._sparse_hits_device(signs, offset, head, key)
                if out is not None:
                    return out
            else:
                raw = self._raw_stream(signs)
                verdict = None
                if raw is not None:
                    arr, ent = raw
                    verdict, live, n_live, nB_real = sparse.raw_elision_plan(
                        arr, ent[3], ent[1], self._prefilter, self.halo, 128)
                    if live is not None:
                        self.stats["sparse_live_frac"] = \
                            n_live / max(nB_real, 1)
                    if verdict == "zero":
                        return self._empty()
                    if verdict == "elide":
                        return self._elided_hits(
                            arr, (ent[3], ent[1]), len(arr), live, n_live,
                            offset, head, nB_real, key)
                if verdict != "dense":
                    ids = self.encode(signs)
                    if len(ids) == 0:
                        return self._empty()
                    out = self._sparse_hits(ids, offset, head, key)
                    if out is not None:
                        return out
                    signs = ids  # already encoded
        packed = self._stepped is not None and self._mxu is None
        if key is None:
            if packed and len(signs):
                return self._auto_stepped_hits(signs, offset, head)
            states = self.scan_states(signs, head=head)
            ends, end_states, idx = decode_matches_arrays(
                states, self.tables, offset)
            return MatchSet(self.machine, self.tables, ends, end_states, idx)
        src = self._source(signs)
        if src is None:
            return self._empty()
        T, Tl = src[2], self._shard_len(src)
        _guard_pos32(T)
        if not packed:
            # K8's stream form: exactly each shard's hit positions
            B, L = _dense_geometry(Tl, self._n_streams_per_device)
            exts = self._shard_exts(src, self.halo, B * L, head)

            def shard_hits(i, e):
                tab = self._tab(i)
                pos, sts, _, n_hit_pos = hits.dense_hits(
                    tab["dflat"], tab["nb_out"], self.V, self.halo, B, L,
                    e[0], **self._dense_fields())
                keep = pos < Tl
                return pos[keep].long() + i * Tl, sts[keep], n_hit_pos
            out = self._on_shards(shard_hits, exts)
            self._check_hits({i: torch.tensor([o[2]]) for i, o in
                              out.items()}, key)
            return self._matchset({i: o[0] for i, o in out.items()},
                                  {i: o[1] for i, o in out.items()}, T,
                                  offset)
        emits, exts = self._emit(src, head)
        self._check_hits({i: e[2].sum(dtype=torch.int32).view(1)
                          for i, e in emits.items()}, key, "at least ")
        out = self._extract(emits, exts, src, lambda n_live: (
            max(8, _pow2(n_live)), key))
        self._check_hits({i: torch.tensor([o[2]]) for i, o in out.items()},
                         key)
        return self._matchset({i: o[0] for i, o in out.items()},
                              {i: o[1] for i, o in out.items()}, T, offset)

    def _emit(self, src, head):
        """K4 over every shard's stream: ({i: (emit [B, L/k], n_hits [B],
        n_live [B])}, the shards' exts)."""
        st = self._stepped
        B, L = _stepped_geometry(self._shard_len(src), st.k,
                                 self._n_streams_per_device)
        if L * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a per-device stream of {L} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow "
                "the int32 per-stream counters; chunk the input with "
                "scanner.session() or raise n_streams_per_device")
        exts = self._shard_exts(src, self._halo_sym, B * L, head)
        emits = self._on_shards(lambda i, e: hits.stepped_emit(
            self._tab(i)["packed"], st.V, st.k, st.count_bits,
            self._halo_steps, B, L, e[0], warm_steps=self._emit_warm), exts)
        return emits, exts

    def _extract(self, emits: dict, exts: dict, src, sizes) -> dict:
        """The refinement of each shard's live grams (ops/hits.py
        ``hits_extract``), ``sizes(n_live) -> (cap, out_size)``: {i:
        (absolute positions int64, states int32, n_hit_pos)}."""
        st, Tl = self._stepped, self._shard_len(src)
        h = self._halo_sym

        def extract(i, em, e):
            emit, _, n_live = em
            cap, out_size = sizes(int(n_live.sum(dtype=torch.int64)))
            tab = self._tab(i)
            body = e[0]
            pos, sts, n_hit_pos = hits.hits_extract(
                st.V, st.k, st.count_bits, cap, out_size, emit,
                lambda p: body[h + p].long(), tab["dflat"], tab["nb_out"])
            keep = pos >= 0
            return pos[keep] + i * Tl, sts[keep], n_hit_pos
        return self._on_shards(extract, emits, exts)

    def _auto_stepped_hits(self, signs, offset, head):
        """Single-pass auto-sized retrieval (JAX ``_auto_stepped_hits``):
        K4 once per shard, the gathered per-shard live and hit counts size
        the refinement at the busiest shard's power-of-two buckets."""
        src = self._source(signs)
        if src is None:
            return self._empty()
        T = src[2]
        _guard_pos32(T)
        st = self._stepped
        emits, exts = self._emit(src, head)
        n_live = np.concatenate(self._gather(
            {i: e[2].sum(dtype=torch.int32).view(1)
             for i, e in emits.items()}))
        max_live = int(n_live.max())
        if max_live == 0:
            return self._empty()
        n_hits_sh = [int(a.sum(dtype=np.int64)) for a in
                     self._gather({i: e[1] for i, e in emits.items()})]
        cap = max(8, _pow2(max_live))
        out_size = min(cap * st.k, max(8, _pow2(max(n_hits_sh))))
        if (self.n_dev * out_size * 8 > T * 4
                and self.n_dev * out_size * 8 > _AUTO_DECODE_FLOOR_BYTES):
            # Match-dense at scale: the gathered hit buffers would pass the
            # per-position decode's states array; decode instead.
            states = self.scan_states(signs, head=head)
            ends, end_states, idx = decode_matches_arrays(
                states, self.tables, offset)
            return MatchSet(self.machine, self.tables, ends, end_states, idx)
        out = self._extract(emits, exts, src, lambda _: (cap, out_size))
        return self._matchset({i: o[0] for i, o in out.items()},
                              {i: o[1] for i, o in out.items()}, T, offset)

    # -- sparse prefilter: retrieval -----------------------------------------

    def _window_matches(self, srcs: dict, idxs: dict, T: int, offset: int,
                        max_hits: Optional[int], shift=None) -> MatchSet:
        """K8's window form over each shard's windows (1-char, halo
        ``self.halo``, blocks of 128). ``shift(i, positions)``: a shard's
        positions made absolute (elided windows' are already). Raises
        past a given ``max_hits`` per shard."""
        halo, L_blk = self.halo, 128

        def shard_hits(i, src, idx):
            tab = self._tab(i)
            pos, sts, _, n_hit_pos = hits.window_hits(
                tab["dflat"], tab["nb_out"], self.V, halo, L_blk, src, idx,
                **self._dense_fields())
            pos = pos.long()
            if shift is not None:
                pos, sts = shift(i, pos, sts)
            return pos, sts, n_hit_pos
        out = self._on_shards(shard_hits, srcs, idxs)
        if max_hits is not None:
            self._check_hits({i: torch.tensor([o[2]]) for i, o in
                              out.items()}, max_hits)
        return self._matchset({i: o[0] for i, o in out.items()},
                              {i: o[1] for i, o in out.items()}, T, offset)

    def _elided_hits(self, arr, lut, T: int, live, n_live: int, offset,
                     head, nB_real: int, max_hits):
        """Hits over host-elided live windows, sharded along the window
        axis, positions absolute through the block indices (JAX
        ``_elided_hits``). Without ``max_hits`` nothing can overflow: K8
        writes exactly the hit positions."""
        _guard_pos32(T)
        tm, idx = sparse.elide_windows(arr, lut, T, live, n_live, head,
                                       self.halo, 128, nB_real,
                                       pad_cols_to=self.n_dev)
        srcs, idxs = self._elided_shards(tm, idx)
        out = self._window_matches(srcs, idxs, T, offset, max_hits)
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return out

    def _sparse_hits(self, ids: np.ndarray, offset, head, max_hits):
        """Filter-then-extract over host ids (JAX ``_sparse_hits``): each
        shard's live windows from its stream, halo from its left
        neighbour. None when not applicable or declined."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        T = len(ids)
        ids, nB_loc, live, n_live, nB_real = self._host_blocks(ids, L_blk)
        if int(n_live.sum()) == 0:
            return self._empty()
        if self._declines(int(n_live.sum()), nB_real):
            return None
        cap = max(8, _pow2(int(n_live.max())))
        Tl = nB_loc * L_blk
        exts = self._shard_exts(("ids", ids), halo, (nB_loc + 1) * L_blk,
                                head)
        return self._window_matches(
            {i: e[0] for i, e in exts.items()},
            self._host_idx(live, nB_loc, cap), T, offset, max_hits,
            lambda i, pos, sts: (pos + i * Tl, sts))

    def _sparse_hits_device(self, ids, offset, head, max_hits):
        """Filter-then-extract over a resident corpus (JAX
        ``_sparse_hits_device``): block filter and K8 on each shard's
        device, no corpus upload. None when not applicable or declined."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        src = self._source(ids)
        if src is None:
            return self._empty()
        T, Tl = src[2], self._shard_len(src)
        _guard_pos32(T)
        blocks = self._device_blocks(src, head, halo, L_blk)
        if blocks is None:
            return None
        exts, filt, n_live, nB_loc, nB_real = blocks
        if int(n_live.sum()) == 0:
            return self._empty()
        if self._declines(int(n_live.sum()), nB_real):
            return None
        cap = min(nB_loc, max(8, _pow2(int(n_live.max()))))
        idxs = {i: sparse.dev_idx(f[0], f[1], nB_loc, cap)
                for i, f in filt.items()}

        def shift(i, pos, sts):
            keep = pos < Tl
            return pos[keep] + i * Tl, sts[keep]
        return self._window_matches({i: e[0] for i, e in exts.items()},
                                    idxs, T, offset, max_hits, shift)

    # -- batch scoring ---------------------------------------------------------

    def count_many(self, docs) -> np.ndarray:
        """Per-document match counts (int64 [len(docs)]) of independent
        documents, dealt across the shards as columns of a time-major
        [L, B] batch (JAX ``ShardedScanner.count_many``): length buckets,
        raw staging where every document takes one LUT. A resident [L, B]
        batch of letter ids (a ``ShardedTensor`` placed with ``axis=1``,
        or a 2-D tensor, B a multiple of the mesh size) is counted where it
        lies; its ids are checked against [0, V)."""
        if isinstance(docs, (ShardedTensor, torch.Tensor)):
            return self._count_many_device(docs)
        n = len(docs)
        if n == 0:
            return np.zeros(0, np.int64)
        k = self._stepped.k if (self._stepped is not None
                                and self._mxu is None) else 1
        out = np.zeros(n, np.int64)
        with self._dispatch:
            raws = DenseScanner._raw_docs(self, docs)
            if raws is not None:
                docs_arrs, ent = raws
            else:
                docs_arrs, ent = [self.encode(d) for d in docs], None
            lengths = np.asarray([len(e) for e in docs_arrs], np.int64)
            for L, idx in DenseScanner._length_buckets(lengths, 128 * k):
                out[idx] = self._count_many_launch(
                    [docs_arrs[i] for i in idx], L, ent)
        return out

    def _count_many_device(self, tm) -> np.ndarray:
        if len(tm.shape) != 2:
            raise ValueError(
                f"device-resident batch must be [L, B] (got "
                f"{len(tm.shape)}-D)")
        if tm.dtype.is_floating_point or tm.dtype.is_complex \
                or tm.dtype == torch.bool:
            raise ValueError("device-resident batch must be integer letter "
                             f"ids (got dtype {tm.dtype})")
        L, B = tm.shape
        if B % self.n_dev:
            raise ValueError(
                f"batch width {B} must be divisible by the {self.n_dev}-"
                "device mesh (pad with all-OOV columns)")
        if not isinstance(tm, ShardedTensor):
            tm = data_sharded(self.mesh, tm, axis=1)
        elif tm.axis != 1:
            raise ValueError("a resident [L, B] batch is sharded along its "
                             "document axis (data_sharded(mesh, tm, "
                             "axis=1))")
        shards = {i: t.to(torch.int32).contiguous()
                  for i, t in tm.shards.items()}
        self._check_range(ShardedTensor(self.mesh, shards, tm.shape,
                                        torch.int32, 1))
        with self._dispatch:
            return self._count_many_kernel(shards, L, B // self.n_dev)

    def _count_many_launch(self, encoded, L: int, ent=None) -> np.ndarray:
        """One bucket: the documents as the columns of [L, B], B a multiple
        of 8 per shard, each shard's columns uploaded to its device."""
        n = len(encoded)
        per_dev = -(-(-(-n // self.n_dev)) // 8) * 8
        tm = np.zeros((L, per_dev * self.n_dev),
                      encoded[0].dtype if ent is not None else np.int32)
        for j, e in enumerate(encoded):
            tm[:len(e), j] = e
        shards = {i: self._snap.place(np.ascontiguousarray(
            tm[:, i * per_dev:(i + 1) * per_dev]), self.mesh.devices[i])
            for i in self.mesh.local}
        return self._count_many_kernel(shards, L, per_dev, ent)[:n]

    def _count_many_kernel(self, shards: dict, L: int, B_local: int,
                           ent=None) -> np.ndarray:
        """Each shard's [L, B_local] columns through the engine's batch
        count (JAX ``_count_many_kernel``): K10 for "mxu", K5 with the
        packed table and L % k == 0, else K6; documents split into c > 1
        blocks warm up from a halo of their own. The per-document combine
        happens on the shard; int64 counts of every column, shard order."""
        if L * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a document stream of {L} symbols could overflow the "
                "int32 per-stream accumulator; split the document")
        st = self._stepped

        def count(i, tm):
            dev = self.mesh.devices[i]
            lut = None if ent is None else ent[0][dev]
            tab = self._tab(i)
            if self._mxu is not None:
                planes, cbits, n_planes, _ = self._mxu
                c, Lp = self._split_for(L, B_local, 128)
                per = scan_mxu.mxu_count_many(
                    planes[dev], self.V, cbits, n_planes,
                    self.halo if c > 1 else 0, c, Lp, tm, lut,
                    planes_t=self._planes_t[dev])
            elif st is not None and L % st.k == 0:
                c, Lp = self._split_for(L, B_local, 128 * st.k)
                per = multistep.stepped_count_many(
                    tab["packed"], st.V, st.k, st.count_bits,
                    self._halo_steps if c > 1 else 0, c, Lp, tm, lut,
                    warm_steps=self._warm_steps)
            else:
                c, Lp = self._split_for(L, B_local, 128)
                per = scan_dense.dense_count_many(
                    tab["dflat"], tab["nb_out"], self.V,
                    self.halo if c > 1 else 0, c, Lp, tm, lut,
                    warm_steps=self._warm_syms)
            return per.view(c, B_local).sum(dim=0, dtype=torch.int64)
        return np.concatenate(self._gather(self._on_shards(count, shards),
                                           torch.int64))

    def _split_for(self, L: int, n_cols_local: int, unit: int):
        """(c, Lp): split each document into c blocks of Lp so that a
        shard's batch reaches its configured stream width (JAX
        ``_split_for``)."""
        target = self._n_streams_per_device
        c = min(-(-target // max(n_cols_local, 1)), max(L // unit, 1))
        if c <= 1:
            return 1, L
        Lp = -(-(-(-L // c)) // unit) * unit
        return -(-L // Lp), Lp
