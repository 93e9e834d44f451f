"""DenseScanner and StreamSession: the device-resident scanning model, in
PyTorch.

The port of ``models/scanner.py:DenseScanner``'s single-device path. It
owns a table snapshot (models/snapshot.py), pinned to one dictionary
version until ``refresh()`` brings it up to the machine's in place, and
scans B parallel streams with halo overlap (ops/blocking.py's exactness
argument) through hand-written kernels:

* ``count``: K3, the packed k-gram count (ops/multistep.py); K9, the
  two-table k-gram count, where (state, count) need more than 31 bits;
  K1, the 1-char dense count (ops/scan_dense.py), where no k-gram table
  exists; with ``engine="mxu"`` K10, the MXU engine's int8 tensor-core
  lookup (ops/scan_mxu.py), and with ``engine="hybrid"`` K11, which runs
  K3's and K10's recurrences on two parts of the streams in one launch
  (ops/scan_hybrid.py);
* ``find_matches``: K4, the k-gram emit scan, then the plain-PyTorch
  refinement of live grams (ops/hits.py); without a packed table, K8, the
  1-char bounded hits, under ``max_hits``, else K2 states decoded on the
  host;
* ``prefilter="on"|"auto"``, the sparse prefilter (ops/sparse.py): a
  filter marks the blocks that hold a keyword letter, on the host over
  raw symbols or ids or on the device over a tensor, and only their halo
  windows are scanned: ``count`` through K7, the window count, uploading
  only the live windows where they are under half the stream, and
  ``find_matches`` through K8's window form;
* ``scan_states``: K2; ``scan_states_sequential``: K2 in one thread;
* ``count_many``: one document per column of a time-major [L, B] batch,
  split into blocks: K5, the packed count of the batch, K9's batch form on
  the two tables, K10's with ``engine="mxu"``, or K6, its dense count;
* ``session()``: a ``StreamSession``, chunked scanning exact across chunk
  edges, over count and find_matches.

bytes, uint8 arrays and str upload their raw symbols and translate them
through a LUT inside the kernel (``device_encode``); other host inputs are
encoded on the host. A 1-D integer ``torch.Tensor`` is taken as letter ids
already encoded (the counterpart of a ``jax.Array`` input) and is checked
against ``[0, V)``, since a CUDA kernel would read out of bounds where XLA
clamps; so is a 2-D integer tensor given to ``count_many``. ``encode``
takes host signs only and raises ``TypeError`` for a tensor, as the JAX
package's does for a ``jax.Array``.

``calibrate=True`` with ``engine="auto"`` measures the engines' production
``count()`` on the scanner's device and binds the fastest
(ops/autotune.py). Retrieval (``find_matches``, ``scan_states``) ignores
the engine.

Host inputs reach the card through the scanner's staging ring
(models/staging.py): pinned slots and a copy stream, so that no upload
copies from pageable memory and the host waits on no copy but a slot's
last; a large raw input is counted in chunks, each chunk's upload
enqueued before the previous chunk's scan. A retrieval decodes its hits
into events on the device (ops/decode.py) and reads back only the events'
columns, through the same ring.

``count``, ``find_matches`` and ``refresh`` are the root spans ``ac.count``,
``ac.find_matches`` and ``ac.refresh`` of utils/profiling.py, whose
children are the staging, the launches, the refinement (``ac.refine``), the
decode (``ac.decode``), the read-back (``ac.readback``), K2 with its states'
read-back (``ac.states``, a root span where ``scan_states`` is called
alone), the compile, the snapshot's diff, rebuild and uploads;
``stats["last_op"]`` names the path the last call took.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..ops.decode import (DecodeTables, decode_matches_arrays,
                          expand_hits_device)
from ..ops import autotune, scan_hybrid, scan_mxu, sparse
from ..ops.hits import (dense_hits, hits_extract, hits_extract_dense,
                        max_hits_error, stepped_emit, window_hits)
from ..ops.multistep import (compose_packed, emit_warm_steps_for,
                             stepped_count, stepped_count_2t,
                             stepped_count_many, stepped_count_many_2t,
                             warm_steps_for)
from ..ops.scan_dense import (dense_count, dense_count_many, dense_states,
                              lookup, sequential_states)
from ..utils import profiling
from .results import MatchSet
from .snapshot import DeviceSnapshot
from .staging import Stager


def _guard_pos32(n_symbols: int) -> None:
    """The JAX package's bound on retrieval: its device positions are
    int32. The port keeps it so that both accept the same inputs."""
    if n_symbols >= (2 ** 31) - (1 << 20):
        raise ValueError(
            f"retrieval positions are int32 on device and this stream has "
            f"{n_symbols} symbols; chunk it with scanner.session()")


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def encode_signs(machine, signs, V: int) -> np.ndarray:
    """Map signs to dense letter ids. An int32 ndarray is taken as
    pre-encoded letter ids and checked against [0, V). Letters registered
    after the snapshot (ids >= V) are unknown letters for it: OOV. A
    ``torch.Tensor`` raises ``TypeError``: its elements are not signs, and
    the vocabulary would map every one of them to OOV."""
    if _is_tensor(signs):
        raise TypeError(
            "encode takes host signs, not a torch.Tensor; a tensor of letter "
            "ids goes to count(), find_matches() or scan_states() as it is")
    if isinstance(signs, np.ndarray) and signs.dtype == np.int32:
        if signs.size and (int(signs.max()) >= V or int(signs.min()) < 0):
            raise ValueError(
                "int32 arrays are treated as pre-encoded letter ids, but "
                f"values fall outside [0, {V}); for integer-sign alphabets "
                "encode via machine.vocab.lookup_many(signs) first")
        return signs
    out = np.asarray(machine.vocab.lookup_many(signs), dtype=np.int32)
    if machine.vocab.size > V and out.size:
        out = np.where(out < V, out, 0)
    return out


def raw_lut_entry(machine, V: int, tables, kind: str, max_cp: int,
                  cache: dict, place):
    """Device LUT for the raw (device-side encode) path: (lut_dev,
    n_entries, needs_max_check, lut_host), or None when the raw path
    cannot be exact. Cached per (vocab version, snapshot V) in ``cache``;
    ``place`` uploads the host LUT. Two contracts: ids >= V mask to OOV
    (snapshot pinning), and raw 0 behaves exactly like OOV (the staging
    pads with raw 0): either lut[0] is OOV, or its letter appears in no
    keyword."""
    vocab = machine.vocab
    key = (kind, getattr(vocab, "_version", 0), V)
    hit = cache.get(key)
    if hit is not None:
        return None if hit == "no" else hit
    fn = getattr(vocab,
                 "byte_lut" if kind == "byte" else "codepoint_lut", None)
    res = None
    if fn is not None:
        res = fn() if kind == "byte" else fn(max_cp)
    if res is None:
        cache.clear()
        cache[key] = "no"
        return None
    if kind == "byte":
        lut, needs_check = np.asarray(res, np.int32).copy(), False
    else:
        lut, needs_check = res
    lut = np.where(lut < V, lut, 0).astype(np.int32)
    lid = int(lut[0])
    if lid != 0 and not bool((tables.delta[:, lid] == 0).all()):
        cache.clear()
        cache[key] = "no"
        return None
    entry = (place(lut), int(lut.shape[0]), needs_check, lut)
    cache.clear()
    cache[key] = entry
    return entry


def raw_stream_for(machine, signs, get_lut):
    """(raw symbol ndarray, lut entry) for device-side encode, or None
    (host-encode path). bytes/uint8 arrays -> raw uint8 through the
    256-entry byte LUT; str -> int32 codepoints through the codepoint
    LUT (utils/vocab.codepoint_lut exactness rules)."""
    if isinstance(signs, (bytes, bytearray)) or (
            isinstance(signs, np.ndarray) and signs.dtype == np.uint8):
        ent = get_lut("byte")
        if ent is None:
            return None
        raw = (np.frombuffer(bytes(signs), np.uint8)
               if not isinstance(signs, np.ndarray) else signs)
        return raw, ent
    if isinstance(signs, str):
        enc = getattr(machine.vocab, "str_encoding", None)
        if enc:  # fixed byte alphabet (ByteMachine): str == its bytes
            ent = get_lut("byte")
            if ent is None:
                return None
            return np.frombuffer(signs.encode(enc), np.uint8), ent
        ent = get_lut("cp")
        if ent is None:
            return None
        cps = np.frombuffer(signs.encode("utf-32-le"),
                            dtype=np.uint32).view(np.int32)
        _, n_lut, needs_check = ent[:3]
        if needs_check and cps.size and int(cps.max()) >= n_lut - 1:
            return None  # beyond the eager LUT: host path stays exact
        return cps, ent
    return None


_UNFIT = {
    "mxu": "automaton too large for the MXU engine (padded states or digit "
           "planes over the ops/scan_mxu.py limits); use engine='gather'",
    "hybrid": "automaton too large for the hybrid engine (padded states over "
              "ops/scan_hybrid.MAX_HYBRID_STATES, or no packed stepped "
              "table); use engine='gather'",
}


def engine_planes(tables, packed: bool) -> dict:
    """Each engine's host digit planes by name, ``scan_mxu.build_planes``'
    (planes, count_bits, n_planes, S_pad), or None where the engine does
    not fit: "mxu" within ``scan_mxu.MAX_MXU_STATES`` padded states,
    "hybrid" within ``scan_hybrid.MAX_HYBRID_STATES`` and with a packed
    k-gram table. One build serves both: the planes depend on the tables
    alone, an engine's limit only on whether it takes them."""
    limits = {"mxu": scan_mxu.MAX_MXU_STATES}
    if packed:
        limits["hybrid"] = scan_hybrid.MAX_HYBRID_STATES
    built = scan_mxu.build_planes(tables.delta, tables.nb_outputs,
                                  max_states=max(limits.values()))
    return {e: built if built is not None and built[3] <= limits.get(e, -1)
            else None for e in _UNFIT}


def bind_scanner(sc, place) -> None:
    """Derive what a scanner's kernels take from its snapshot, its halo
    and its engine, for ``DenseScanner`` and the mesh's ``ShardedScanner``
    alike: the halo in gram steps (``_halo_steps``; ``_halo_sym`` in
    symbols), the stepped kernels' warm-up (``_warm_steps``, from the
    tables' depth whatever the halo, ``multistep.warm_steps_for``), K4's,
    one symbol longer (``_emit_warm``, ``emit_warm_steps_for``), and the
    1-char kernels' (K1, K2, K6, K7 dense, K8: ``_warm_syms``, in symbols,
    whether or not a stepped table exists); a wrong value counts wrong
    with no error. Then it drops the raw-encode LUTs, whose exactness
    rests on the tables (raw_lut_entry), and binds the engine's digit
    planes (``_mxu`` or ``_hybrid``: (placed planes, count_bits, n_planes,
    S_pad)) with the kernels' copy keyed by (state, letter) (``_planes_t``,
    ``scan_mxu.transpose_planes``), made here and never per call.
    ``place`` puts the host planes on the scanner's device (a tensor), or
    on each device of a mesh (a dict by device). The planes come from
    ``sc._engine_planes`` while a calibration holds them, else from
    ``engine_planes``."""
    st, tables = sc._stepped, sc.tables
    k = st.k if st is not None else 0
    sc._halo_steps = -(-sc.halo // k) if k else 0
    sc._halo_sym = sc._halo_steps * k
    sc._warm_syms, grams = (warm_steps_for(tables, j) for j in (1, k or 1))
    sc._warm_steps = grams if k else 0
    sc._emit_warm = emit_warm_steps_for(tables, k) if k else 0
    sc._lut_cache.clear()
    sc._mxu = sc._hybrid = sc._planes_t = None
    if sc._engine not in _UNFIT:
        return
    built = (sc._engine_planes
             or engine_planes(tables, sc._snap.packed is not None))[sc._engine]
    if built is None:
        raise ValueError(_UNFIT[sc._engine])
    planes = place(built[0])
    setattr(sc, "_" + sc._engine, (planes,) + built[1:])
    sc._planes_t = ({d: scan_mxu.transpose_planes(p, sc.V, built[2])
                     for d, p in planes.items()} if isinstance(planes, dict)
                    else scan_mxu.transpose_planes(planes, sc.V, built[2]))


def calibrate_scanner(sc, device, force: bool, key_suffix: str = "",
                      agree=None) -> None:
    """Bind the engine measured fastest on ``device`` (ops/autotune.py):
    the probe runs where more than one engine fits, else gather is bound;
    the choice is cached per geometry, its key ended by ``key_suffix``.
    ``agree`` turns the choice into the one every process takes. The
    planes are built once, for the candidates, the probe's rebinds and the
    winner's. Holds the scanner's dispatch lock, so no scan on another
    thread sees a half-rebound scanner."""
    with sc._dispatch:
        tabs = sc.tables
        sc._engine_planes = engine_planes(tabs, sc._snap.packed is not None)
        try:
            candidates = ["gather"] + [e for e, p in sc._engine_planes.items()
                                       if p is not None]
            choice = "gather"
            if len(candidates) > 1:
                key = autotune.geometry_key(tabs.n_states, sc.V, sc.step_k,
                                            device) + key_suffix
                choice = None if force else autotune.cached_choice(key)
                if choice not in candidates:
                    choice = autotune.probe(sc, candidates)
                    autotune.store_choice(key, choice)
            sc._engine = choice if agree is None else agree(choice)
            sc._bind()
        finally:
            sc._engine_planes = None


class DenseScanner:
    # Past _pipeline_min symbols a raw host input is counted in
    # _pipeline_chunk-symbol chunks, each with its halo taken from the raw
    # input itself, staged through a ring of _pipeline_depth pinned slots
    # (models/staging.py). Chunk and depth are chip_smoke.py's sweep on an
    # H100 80GB HBM3 at 700 W (count() of the 64 MiB slice from bytes,
    # 16,384 streams; best ms at depths 2-4, four runs, a call each):
    # 2 MiB chunks 8.2-20.6, 4 MiB 5.6-12.6, 8 MiB 4.3-9.1, 16 MiB 3.1-6.5,
    # 16 MiB the best in every run and its depths within each other's
    # noise, so 2, the least pinned memory. A single staged upload and
    # launch ties it there (3.3-5.4 ms); _pipeline_min stays the JAX
    # package's, since the pipeline holds only its ring on the device
    # whatever the input's size.
    _pipeline_min = 16 << 20
    _pipeline_chunk = 16 << 20
    _pipeline_depth = 2

    def __init__(self, machine, n_streams: "int | str" = "auto",
                 halo: Optional[int] = None, tables=None,
                 step_k: "int | str" = "auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 engine: str = "auto", prefilter: str = "off",
                 device_encode: bool = True,
                 device_encode_max_cp: int = 1024,
                 calibrate: bool = False, device="cuda",
                 snapshot: Optional[DeviceSnapshot] = None):
        """The JAX scanner's keyword arguments, plus ``device`` (where the
        tables live and the kernels run; there is no fallback to the CPU)
        and ``snapshot`` (prebuilt tables on that device, e.g. from
        utils/convert.py, in place of ``tables``/``step_k``).

        ``engine``: "gather" (the k-gram table, or the 1-char tables
        where none exists), "mxu" (K10, the one-hot digit-plane product;
        raises ``ValueError`` when the automaton has more than
        ``scan_mxu.MAX_MXU_STATES`` padded states), "hybrid" (K11: most
        streams through the packed table, ``scan_hybrid.mxu_cols`` of
        them through the planes; raises when the automaton has more than
        ``scan_hybrid.MAX_HYBRID_STATES`` padded states or no packed
        table), or "auto". The JAX package's "auto" picks by crossovers
        measured on a TPU v5e; the port carries none over, so without
        ``calibrate`` "auto" is "gather", on the card as on the CPU.
        ``calibrate``: with "auto", time the available engines' production
        ``count()`` once on this device and bind the fastest; the choice
        is cached per device and automaton geometry (ops/autotune.py).
        An engine that does not fit after a ``refresh()`` raises there.

        ``prefilter``: "off", "on" (count and retrieve through the sparse
        prefilter) or "auto" (the prefilter, unless over half the blocks
        are live: then the dense kernels)."""
        if engine not in ("auto", "gather", "mxu", "hybrid"):
            raise ValueError(f"unknown engine {engine!r}")
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        self._engine = engine
        if prefilter not in ("off", "auto", "on"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        self._prefilter = prefilter
        self.machine = machine
        self.device = torch.device(device)
        self._auto_streams = n_streams == "auto"
        self.n_streams = 512 if self._auto_streams else int(n_streams)
        if snapshot is None:
            snapshot = DeviceSnapshot(
                tables if tables is not None else machine.compile(),
                step_k=step_k, step_budget_bytes=step_budget_bytes,
                device=self.device)
        elif snapshot.device != self.device:
            raise ValueError(f"snapshot on {snapshot.device}, scanner on "
                             f"{self.device}")
        self._snap = snapshot
        self._halo_auto = halo is None
        self.halo = int(halo) if halo is not None else max(
            self.tables.max_depth - 1, 0)
        self.stats: dict = {}
        # Serialises the public device calls on one scanner, refresh()
        # included; use one scanner per thread to scan in parallel.
        self._dispatch = threading.RLock()
        self._device_encode = bool(device_encode)
        self._device_encode_max_cp = int(device_encode_max_cp)
        self._lut_cache: dict = {}
        self._pk1_cache = None
        self._dec_cache = None
        self._ring: Optional[Stager] = None
        self._engine_planes = None
        self._bind()
        if calibrate and engine == "auto":
            self._calibrate_engine()

    def _calibrate_engine(self, force: bool = False) -> None:
        """``calibrate_scanner`` on the scanner's device."""
        calibrate_scanner(self, self.device, force)

    def recalibrate(self) -> str:
        """Measure the engines again now, ignoring the cached choice, and
        bind the winner; safe against scans on other threads. Returns the
        engine's name."""
        self._calibrate_engine(force=True)
        return self._engine

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
    def version(self) -> int:
        return self.tables.version

    def _bind(self) -> None:
        """``bind_scanner`` with the planes on the scanner's device.
        ``__init__``, ``refresh()`` and calibration call it."""
        bind_scanner(self, self._snap.place)

    # -- incremental snapshot refresh ----------------------------------------

    def refresh(self) -> bool:
        """Bring the pinned snapshot up to the machine's current dictionary
        (``models/scanner.py:DenseScanner.refresh``): re-emit the dense
        tables on the host, upload them, and diff them against the
        snapshot on its device, where the changed rows and the k-gram
        cells routed through a changed edge are found and recomputed
        (``models/snapshot.py:DeviceSnapshot.refresh``) and written into
        the device tables in place.

        Returns True for the in-place path (or no change), False when it
        fell back to a full rebuild (vocabulary growth, state capacity,
        packed count width, or a large delta). Either way the scanner then
        scans exactly as a freshly built one. Open sessions see the new
        dictionary from their next chunk on. The refresh holds the dispatch
        lock, so no scan of this scanner runs against half-written
        tables."""
        with profiling.span("ac.refresh") as sp:
            new = self.machine.compile()
            if new.version == self.tables.version:
                sp.note("outcome", "noop")
                return True
            with self._dispatch:
                status = self._snap.refresh(new)
                self._refresh_halo()
                self._bind()
            rows = self._snap.last_refresh.get("rows", 0)
            cells = self._snap.last_refresh.get("cells", 0)
            sp.note("outcome", status)
            sp.note("rows", rows)
            sp.note("cells", cells)
        self._record("refresh")
        self.stats["refresh_rows"] = rows
        self.stats["refresh_cells"] = cells
        return not status.startswith("rebuild")

    def _refresh_halo(self) -> None:
        """Grow an automatic halo when a new keyword outgrows it, rounded up
        to a multiple of 8 (the JAX package's rule, there to spare
        recompiles)."""
        need = max(self.tables.max_depth - 1, 0)
        if self._halo_auto and need > self.halo:
            self.halo = -(-need // 8) * 8

    # -- encoding and staging ----------------------------------------------

    def encode(self, signs: Sequence[Any]) -> np.ndarray:
        """Map a stream of signs to dense letter ids (OOV -> 0). int32
        arrays pass through as pre-encoded ids (bounds-checked)."""
        return encode_signs(self.machine, signs, self.V)

    def _get_lut(self, kind: str):
        return raw_lut_entry(self.machine, self.V, self.tables, kind,
                             self._device_encode_max_cp, self._lut_cache,
                             self._snap.place)

    def _raw_stream(self, signs):
        if not self._device_encode:
            return None
        return raw_stream_for(self.machine, signs, self._get_lut)

    def _streams_for(self, T: int) -> int:
        if not self._auto_streams:
            return self.n_streams
        b = max(512, min(16384, T // 4096))
        return 1 << (b - 1).bit_length()

    def _layout(self, T: int, unit: int):
        """(B, L): streams and per-stream symbols, L a multiple of unit."""
        B = self._streams_for(T)
        return B, max(unit, -(-(-(-T // B)) // unit) * unit)

    @property
    def _stager(self) -> Stager:
        """The scanner's staging ring (models/staging.py), made at first
        use: ``_pipeline_depth`` pinned slots of a chunk's bytes at least.
        Every host upload of a scan goes through it, under the dispatch
        lock; ``DeviceSnapshot.place`` uploads only tables."""
        if self._ring is None:
            self._ring = Stager(self.device, self._pipeline_depth,
                                self._pipeline_chunk)
        return self._ring

    def _head_ids(self, head, halo: int) -> np.ndarray:
        """The last ``halo`` letter ids of ``head`` (the symbols before the
        stream), left-padded with OOV; checked against [0, V) because the
        kernels index tables with them."""
        head_ids = np.zeros(halo, np.int32)
        if head is not None and len(head) and halo:
            tail = np.asarray(head)[-min(len(head), halo):]
            if int(tail.min()) < 0 or int(tail.max()) >= self.V:
                raise ValueError(f"head letter ids fall outside [0, {self.V})")
            head_ids[halo - len(tail):] = tail
        return head_ids

    def _stream_ext_raw(self, raw: np.ndarray, head, halo: int, unit: int):
        """Stage a raw symbol stream for the raw kernels: (ext [halo + B*L]
        in the raw dtype, padded with raw 0 == OOV; head_ids [halo] for
        stream 0's warm-up rows; B, L, T)."""
        T = len(raw)
        B, L = self._layout(T, unit)
        stager = self._stager
        return (stager.padded(raw, halo, B * L),
                stager.upload(self._head_ids(head, halo)), B, L, T)

    def _stream_ext(self, ids: np.ndarray, head, halo: int, unit: int):
        """Stage letter ids: (ext [halo + B*L] int32 = head, ids, OOV pad;
        B, L, T)."""
        T = len(ids)
        B, L = self._layout(T, unit)
        return self._stager.padded(np.asarray(ids, np.int32), halo, B * L,
                                   self._head_ids(head, halo)), B, L, T

    def _check_ids(self, ids: torch.Tensor) -> None:
        """Tensor input: 1-D integer letter ids within [0, V)."""
        if ids.dim() != 1 or ids.dtype.is_floating_point \
                or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(
                "tensor input must be 1-D integer letter ids "
                f"(got {ids.dtype}, shape {tuple(ids.shape)})")
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= self.V):
            raise ValueError(f"tensor letter ids fall outside [0, {self.V})")

    def _ext_device(self, ids: torch.Tensor, head, halo: int, unit: int):
        """ext [halo + B*L] int32 built on the device from a letter-id
        tensor: no host staging."""
        T = ids.numel()
        B, L = self._layout(T, unit)
        ext = torch.cat([
            self._stager.upload(self._head_ids(head, halo)),
            ids.to(device=self.device, dtype=torch.int32),
            torch.zeros(B * L - T, dtype=torch.int32, device=self.device)])
        return ext, B, L

    def _stage(self, signs, raw, head, halo: int, unit: int):
        """(ext, lut, head_ids, B, L, T) for a scan: raw symbols with their
        LUT (``raw`` from _raw_stream), a letter-id tensor, or ids encoded
        on the host."""
        if raw is not None:
            ext, head_ids, B, L, T = self._stream_ext_raw(raw[0], head, halo,
                                                          unit)
            return ext, raw[1][0], head_ids, B, L, T
        if _is_tensor(signs):
            self._check_ids(signs)
            ext, B, L = self._ext_device(signs, head, halo, unit)
            return ext, None, None, B, L, signs.numel()
        ext, B, L, T = self._stream_ext(self.encode(signs), head, halo, unit)
        return ext, None, None, B, L, T

    # -- scanning ------------------------------------------------------------

    def scan_states(self, signs, head=None) -> np.ndarray:
        """states[t] after consuming symbol t, for the whole stream (K2).
        The span ``ac.states`` covers the staging, K2 and the states'
        read-back: symbols, the ``bytes`` read back and the ``table_bytes``
        of the 1-char table K2 walks."""
        if len(signs) == 0:
            return np.zeros(0, dtype=np.int32)
        # The LUT and the tables are read under the lock: refresh() swaps
        # them.
        with profiling.span("ac.states") as sp, self._dispatch:
            sp.note("symbols", len(signs))
            raw = self._raw_stream(signs)
            ext, lut, head_ids, B, L, T = self._stage(signs, raw, head,
                                                      self.halo, 128)
            dflat = self._snap.dflat
            out = dense_states(dflat, self.V, self.halo, B, L, ext, lut,
                               head_ids, **self._dense_fields())
            out = out[:T].cpu().numpy()
            if sp:
                sp.note("bytes", out.nbytes)
                sp.note("table_bytes", dflat.nbytes)
        self._record("scan_states")
        return out

    def count(self, signs, head=None) -> int:
        """Total number of keyword occurrences in the stream."""
        if len(signs) == 0:
            return 0
        with profiling.span("ac.count") as sp, self._dispatch:
            sp.note("symbols", len(signs))
            raw = self._raw_stream(signs)
            if self._prefilter != "off":
                n = self._count_prefilter(signs, raw, head)
            else:
                n = self._count_dense(signs, raw, head)
        self._record("count")
        return n

    def _count_dense(self, signs, raw, head) -> int:
        """Count through the engine's kernel over the whole stream
        (``_count_kernel``), raw inputs of two chunks or more in pipelined
        chunks. The two-table count takes host-encoded ids, as the JAX
        scanner's (``models/scanner.py:699,909``); the MXU engine reads
        the planes, never the k-gram tables, and keeps its raw forms."""
        if raw is not None and self._two_table and self._mxu is None:
            raw = None
        if raw is not None and len(raw[0]) >= self._pipeline_min:
            n = self._count_raw_pipelined(raw[0], raw[1], head)
            if n is not None:
                return n
        halo, unit, count = self._count_kernel()
        ext, lut, head_ids, B, L, _ = self._stage(signs, raw, head, halo,
                                                  unit)
        self._guard_acc(L)
        # int64 grand total: per-stream int32 totals can pass 2^31
        return int(count(B, L, ext, lut, head_ids).sum(dtype=torch.int64))

    # -- sparse prefilter: count ---------------------------------------------

    @property
    def _two_table(self) -> bool:
        """The k-gram tables are the two-table form (K9)."""
        return self._snap.delta_k is not None

    @property
    def _packed_windows(self) -> bool:
        """The prefilter counts k-gram windows through the packed table:
        one exists and the engine is not "mxu" (the JAX scanner's
        ``use_stepped``, ``models/scanner.py:832-836``)."""
        return self._mxu is None and self._snap.packed is not None

    def _sparse_geometry(self):
        """(k, halo, L_blk) of the prefilter's count: k-gram windows with
        ``_packed_windows``, else 1-char windows."""
        if self._packed_windows:
            k = self._stepped.k
            return k, self._halo_sym, 128 * k
        return 1, self.halo, 128

    def _count_prefilter(self, signs, raw, head) -> int:
        """The prefilter's count routing (``models/scanner.py:573-648``):
        a tensor takes the device block filter; raw symbols the raw
        filter and elision, whose "dense" verdict goes straight to the
        dense raw kernels; otherwise the ids encoded on the host take the
        host filter. Each declines (None) to the dense kernels."""
        if _is_tensor(signs):
            n = self._sparse_count_device(signs, head)
            return self._count_dense(signs, None, head) if n is None else n
        if raw is not None:
            n = self._sparse_count_raw(raw, head)
            if n == "dense":
                return self._count_dense(signs, raw, head)
            if n is not None:
                return n
        ids = self.encode(signs)
        if not len(ids):
            return 0
        n = self._sparse_count(ids, head)
        return self._count_dense(ids, None, head) if n is None else n

    def _window_count(self, src, idx=None) -> int:
        """The count of live-block windows (``ops/sparse.py``): K10 with
        ``engine="mxu"``, else K7, its stepped body with a packed table,
        else its dense one; the int64 total."""
        st, snap = self._stepped, self._snap
        k, halo, L_blk = self._sparse_geometry()
        if self._mxu is not None:
            planes, cbits, n_planes, _ = self._mxu
            per = sparse.sparse_count_mxu(planes, self.V, cbits, n_planes,
                                          halo, L_blk, src, idx,
                                          planes_t=self._planes_t)
        elif self._packed_windows:
            per = sparse.sparse_count_stepped(
                snap.packed, st.V, k, st.count_bits, self._halo_steps, L_blk,
                src, idx)
        else:
            per = sparse.sparse_count(snap.dflat, snap.nb_out, self.V, halo,
                                      L_blk, src, idx, **self._dense_fields())
        return int(per.sum(dtype=torch.int64))

    def _sparse_filter_device(self, ids: torch.Tensor, head, halo: int,
                              L_blk: int):
        """The device block filter over a letter-id tensor: (ext, idx [cap]
        int32, n_live, nB_real), idx None when no block is live. ext
        [halo + (nB+1)*L_blk] int32 is built on the device (head, ids, OOV
        pad to a pow2 nB of blocks and one spare all-OOV block). One
        4-byte synchronisation."""
        self._check_ids(ids)
        T = ids.numel()
        nB_real = -(-T // L_blk)
        nB = 1 << (nB_real - 1).bit_length()
        ext = torch.cat([
            self._stager.upload(self._head_ids(head, halo)),
            ids.to(device=self.device, dtype=torch.int32),
            torch.zeros((nB + 1) * L_blk - T, dtype=torch.int32,
                        device=self.device)])
        order, n_live = sparse.block_filter(ext, nB, L_blk, halo)
        self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if n_live == 0:
            return ext, None, 0, nB_real
        cap = min(nB, max(8, 1 << (n_live - 1).bit_length()))
        return ext, sparse.dev_idx(order, n_live, nB, cap), n_live, nB_real

    def _declines(self, n_live: int, nB_real: int) -> bool:
        """The "auto" gate: over half the blocks live."""
        return self._prefilter == "auto" and n_live * 2 > nB_real

    def _sparse_count_device(self, ids: torch.Tensor, head) -> Optional[int]:
        """Filter-then-verify over a letter-id tensor
        (``models/scanner.py:823-872``): the block filter and K7 run on
        the device over the resident order, no host pass and no index
        upload. None when the halo is wider than a block or the "auto"
        gate declines."""
        _, halo, L_blk = self._sparse_geometry()
        if halo > L_blk:
            return None
        ext, idx, n_live, nB_real = self._sparse_filter_device(ids, head,
                                                               halo, L_blk)
        if n_live == 0:
            return 0
        if self._declines(n_live, nB_real):
            return None
        self._guard_acc(halo + L_blk)
        return self._window_count(ext, idx)

    def _sparse_count(self, ids: np.ndarray, head) -> Optional[int]:
        """Filter-then-verify over host ids (``models/scanner.py:934-1000``):
        the host marks live blocks; under half the stream in live windows,
        only those upload (``_elided_count``), else the stream uploads with
        its live-block index list. None when not applicable or the "auto"
        gate declines."""
        _, halo, L_blk = self._sparse_geometry()
        if halo > L_blk:
            return None
        T = len(ids)
        nB_real = -(-T // L_blk)
        live = sparse.live_blocks(ids, L_blk)
        n_live = int(live.sum())
        self.stats["sparse_live_frac"] = n_live / nB_real
        if n_live == 0:
            return 0  # all OOV: nothing can match, no launch
        if self._declines(n_live, nB_real):
            return None
        if n_live * (halo + L_blk) * 2 < max(T, 1):
            return self._elided_count(ids, None, T, live, n_live, head,
                                      nB_real)
        self._guard_acc(halo + L_blk)
        return self._window_count(*self._indexed_windows(ids, live, n_live,
                                                         head, halo, L_blk))

    def _indexed_windows(self, ids: np.ndarray, live, n_live: int, head,
                         halo: int, L_blk: int):
        """Upload host ids for the index-list form (``ops/sparse.py``):
        (ext [halo + (nB+1)*L_blk] int32 = head, ids, OOV pad to a pow2 nB
        of blocks and one spare all-OOV block; idx [cap] int32, the live
        blocks, then pad slots at the spare block)."""
        nB = 1 << (len(live) - 1).bit_length()
        idx = np.full(max(8, 1 << (n_live - 1).bit_length()), nB, np.int32)
        idx[:n_live] = np.flatnonzero(live)
        stager = self._stager
        return (stager.padded(np.asarray(ids, np.int32), halo,
                              (nB + 1) * L_blk, self._head_ids(head, halo)),
                stager.upload(idx))

    def _sparse_count_raw(self, raw, head):
        """Filter and elision over raw symbols before any encode
        (``models/scanner.py:1011-1040``): an int count, "dense" (the
        "auto" gate found the corpus match-dense) or None (the id path
        decides)."""
        arr, (_, n_lut, _, lut_host) = raw
        _, halo, L_blk = self._sparse_geometry()
        verdict, live, n_live, nB_real = sparse.raw_elision_plan(
            arr, lut_host, n_lut, self._prefilter, halo, L_blk)
        if live is not None:
            self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if verdict == "zero":
            return 0
        if verdict == "dense":
            return "dense"
        if verdict == "na":
            return None
        return self._elided_count(arr, (lut_host, n_lut), len(arr), live,
                                  n_live, head, nB_real)

    def _elided_count(self, arr, lut, T: int, live, n_live: int, head,
                      nB_real: int) -> int:
        """Host dead-block elision (``models/scanner.py:1042-1068``): only
        the live blocks' windows upload, wire bytes the live fraction of
        the corpus, and K7 counts them."""
        _, halo, L_blk = self._sparse_geometry()
        tm, _ = sparse.elide_windows(arr, lut, T, live, n_live, head, halo,
                                     L_blk, nB_real)
        self._guard_acc(halo + L_blk)
        n = self._window_count(self._stager.upload(tm))
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return n

    def _count_kernel(self):
        """(halo, unit, count(B, L, ext, lut=None, head_ids=None) ->
        per-stream int32 totals [B]), the engine's stream count (the JAX
        scanner's ``_count_dispatch``, ``models/scanner.py:744-786``): K10
        for "mxu", K11 for "hybrid", else K3 with a packed table, K9 with
        the two tables, K1 with neither."""
        st, snap = self._stepped, self._snap
        if self._mxu is not None:
            planes, cbits, n_planes, _ = self._mxu
            return self.halo, 128, functools.partial(
                scan_mxu.mxu_count, planes, self.V, cbits, n_planes,
                self.halo, planes_t=self._planes_t)
        if self._hybrid is not None:
            return self._halo_sym, 128 * st.k, self._hybrid_count
        if snap.packed is not None:
            return self._halo_sym, 128 * st.k, functools.partial(
                stepped_count, snap.packed, st.V, st.k, st.count_bits,
                self._halo_steps, warm_steps=self._warm_steps)
        if self._two_table:
            return self._halo_sym, 128 * st.k, functools.partial(
                stepped_count_2t, snap.delta_k, snap.cnt_k, st.V, st.k,
                self._halo_steps, warm_steps=self._warm_steps)
        return self.halo, 128, functools.partial(
            dense_count, snap.dflat, snap.nb_out, self.V, self.halo,
            **self._dense_fields())

    def _dense_fields(self) -> dict:
        """The 1-char stream kernels' (K1, K2, K7 dense, K8) sub-stream
        fields: the warm-up of the current tables and their real rows."""
        return dict(warm_steps=self._warm_syms,
                    n_states=self.tables.n_states)

    def _hybrid_count(self, B: int, L: int, ext, lut=None, head_ids=None):
        """K11 over B streams: the last ``scan_hybrid.mxu_cols(B, S_pad)``
        of them through the planes, all of them where that passes B (the
        JAX scanner's slices ``[:, :B - B2]`` and ``[:, B - B2:]`` do the
        same)."""
        st = self._stepped
        planes, cbm, n_planes, S_pad = self._hybrid
        B2 = min(scan_hybrid.mxu_cols(B, S_pad), B)
        return scan_hybrid.hybrid_count(
            self._snap.packed, planes, st.V, st.k, st.count_bits,
            self._halo_steps, n_planes, cbm, B - B2, B, L, ext, lut,
            head_ids, planes_t=self._planes_t, warm_steps=self._warm_steps)

    def _count_raw_pipelined(self, raw, ent, head) -> Optional[int]:
        """Raw count of a large host input in independent chunks through
        the engine's stream count, each chunk with its halo encoded from
        the raw input through the host LUT. Each chunk is staged in the
        next slot of the staging ring (models/staging.py) and launched on
        the device buffer its copy filled, with no synchronisation but the
        one at the end. Chunk i+1 is staged (filled, its copy enqueued)
        before chunk i launches, so its copy is in flight while chunk i's
        work is enqueued and run. None when the input is under two
        chunks."""
        lut_dev, n_lut, _, lut_host = ent
        halo, unit, count = self._count_kernel()
        T = len(raw)
        C = self._pipeline_chunk
        n_chunks = -(-T // C)
        if n_chunks < 2:
            return None
        B, L = self._layout(C, unit)
        self._guard_acc(L)
        stager = self._stager

        def stage(i):
            start = i * C
            if i == 0:
                head_ids = self._head_ids(head, halo)
            else:
                # the previous chunk's last raw symbols through the LUT the
                # kernel uses, clamped like its lookup
                head_raw = np.minimum(
                    raw[start - halo:start].astype(np.int64), n_lut - 1)
                head_ids = lut_host[head_raw]
            return stager.stage(head_ids, raw[start:start + C], halo + B * L)

        totals = []
        staged = stage(0)
        for i in range(n_chunks):
            slot = staged
            if i + 1 < n_chunks:
                staged = stage(i + 1)
            ext, head_dev = stager.ready(slot)
            totals.append(count(B, L, ext, lut_dev, head_dev))
            stager.release(slot)
        return int(torch.stack(totals).sum(dtype=torch.int64))

    def _guard_acc(self, stream_symbols: int) -> None:
        """Per-stream totals accumulate in int32 on the device: a stream of
        L symbols holds at most L * max(nb_outputs) matches. Raise rather
        than wrap."""
        if stream_symbols * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a stream of {stream_symbols} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow the "
                "int32 per-stream accumulator; chunk the input or raise "
                "n_streams")

    # -- batch scoring ---------------------------------------------------------

    def count_many(self, docs) -> np.ndarray:
        """Per-document match counts (int64 [len(docs)]) of a batch of
        independent documents (``models/scanner.py:DenseScanner.count_many``).

        Each document is one column of a time-major [L, B] batch, starts at
        the root and is padded with the OOV id 0, which sends every state to
        the root and never matches (the reference's modification [3]), so
        it adds nothing. Documents are grouped into power-of-two length
        buckets (multiples of 128*k), one launch per bucket, and long
        documents are split into blocks with a halo from the same document
        (``_split_for``). When every document takes the same raw LUT
        (bytes or str), the batch is staged raw and encoded in the kernel.

        A 2-D integer ``torch.Tensor`` [L, B] is a batch of letter ids
        already encoded, one document per column, padded with 0 (the
        counterpart of a ``jax.Array``); it is checked against [0, V)."""
        if _is_tensor(docs):
            return self._count_many_device(docs)
        n = len(docs)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        out = np.zeros(n, dtype=np.int64)
        with self._dispatch:
            unit = 128 * (self._stepped.k if self._stepped is not None
                          and self._mxu is None else 1)
            raws = self._raw_docs(docs)
            if raws is not None:
                docs_arrs, ent = raws
            else:
                docs_arrs, ent = [self.encode(d) for d in docs], None
            lengths = np.asarray([len(e) for e in docs_arrs], np.int64)
            for L, idx in self._length_buckets(lengths, unit):
                self._guard_acc(L)
                out[idx] = self._count_many_launch(
                    [docs_arrs[i] for i in idx], L, ent)
        self._record("count_many" if ent is None else "count_many_raw")
        return out

    def _raw_docs(self, docs):
        """(raw symbol arrays, LUT entry) when every document takes the
        same raw LUT, else None (host encode, also the two-table count's
        input, as in the JAX scanner)."""
        if not self._device_encode or (self._mxu is None
                                       and self._two_table):
            return None
        out, ent0 = [], None
        for d in docs:
            r = self._raw_stream(d)
            if r is None:
                return None
            raw, ent = r
            if ent0 is None:
                ent0 = ent
            elif ent is not ent0:
                return None  # byte and codepoint LUTs in one batch
            out.append(raw)
        return (out, ent0) if out else None

    def _count_many_device(self, tm: torch.Tensor) -> np.ndarray:
        """Scoring of a batch already on the device: ``tm`` [L, B] integer
        letter ids, checked against [0, V) (the reference clamps)."""
        if tm.dim() != 2:
            raise ValueError(
                f"device-resident batch must be [L, B] (got {tm.dim()}-D)")
        if tm.dtype.is_floating_point or tm.dtype.is_complex \
                or tm.dtype == torch.bool:
            raise ValueError("device-resident batch must be integer letter "
                             f"ids (got dtype {tm.dtype})")
        if tm.numel() and (int(tm.min()) < 0 or int(tm.max()) >= self.V):
            raise ValueError(
                f"device-resident letter ids fall outside [0, {self.V})")
        L, B = tm.shape
        tm = tm.to(device=self.device, dtype=torch.int32).contiguous()
        with self._dispatch:
            self._guard_acc(L)
            out = self._count_many_kernel(tm, L, B)
        self._record("count_many_device")
        return out

    @staticmethod
    def _length_buckets(lengths: np.ndarray, unit: int):
        """(L, document indices) per power-of-two multiple of ``unit``
        covering the documents' lengths, longest first."""
        L_each = np.maximum(lengths, 1)  # empty documents: smallest bucket
        buckets = unit * (1 << np.maximum(
            0, np.ceil(np.log2(np.maximum(L_each / unit, 1))).astype(np.int64)))
        for L in np.unique(buckets)[::-1]:
            yield int(L), np.flatnonzero(buckets == L)

    def _split_for(self, L: int, n_cols: int, unit: int):
        """(c, Lp): split each document into c blocks of Lp symbols (a
        multiple of unit, L <= c*Lp) so that a batch of few long documents
        has the stream path's width, ``_streams_for(L * n_cols)``
        columns."""
        target = self._streams_for(L * max(n_cols, 1))
        c = min(-(-target // max(n_cols, 1)), max(L // unit, 1))
        if c <= 1:
            return 1, L
        Lp = -(-(-(-L // c)) // unit) * unit
        return -(-L // Lp), Lp

    def _count_many_launch(self, encoded, L: int, ent=None) -> np.ndarray:
        """One bucket: stage the documents as the columns of a [L, B]
        batch (B a multiple of 8), raw symbols with ``ent``, and count."""
        n = len(encoded)
        B = -(-n // 8) * 8
        tm = np.zeros((L, B), dtype=encoded[0].dtype if ent is not None
                      else np.int32)
        for j, e in enumerate(encoded):
            tm[:len(e), j] = e
        return self._count_many_kernel(self._stager.upload(tm), L, B,
                                       ent)[:n]

    def _count_many_kernel(self, tm: torch.Tensor, L: int, B: int,
                           ent=None) -> np.ndarray:
        """Count a [L, B] batch on the device (``models/scanner.py:
        1215-1250``): K10 with ``engine="mxu"``; K5 with a packed table and
        L % k == 0; K9 with the two tables, ids and L % k == 0 (no split
        or halo, as the reference); else K6. Documents split into c > 1
        blocks warm up from a halo of their own; c == 1 takes none, as in
        the reference. Returns int64 counts [B]."""
        st, snap = self._stepped, self._snap
        lut = None if ent is None else ent[0]
        if self._mxu is not None:
            planes, cbits, n_planes, _ = self._mxu
            c, Lp = self._split_for(L, B, 128)
            per = scan_mxu.mxu_count_many(
                planes, self.V, cbits, n_planes, self.halo if c > 1 else 0,
                c, Lp, tm, lut, planes_t=self._planes_t)
        elif snap.packed is not None and L % st.k == 0:
            c, Lp = self._split_for(L, B, 128 * st.k)
            per = stepped_count_many(
                snap.packed, st.V, st.k, st.count_bits,
                self._halo_steps if c > 1 else 0, c, Lp, tm, lut,
                warm_steps=self._warm_steps)
        elif self._two_table and lut is None and L % st.k == 0:
            c = 1
            per = stepped_count_many_2t(snap.delta_k, snap.cnt_k, st.V, st.k,
                                        tm, warm_steps=self._warm_steps)
        else:
            c, Lp = self._split_for(L, B, 128)
            per = dense_count_many(snap.dflat, snap.nb_out, self.V,
                                   self.halo if c > 1 else 0, c, Lp, tm, lut,
                                   warm_steps=self._warm_syms)
        return per.view(c, B).sum(dim=0, dtype=torch.int64).cpu().numpy()

    # -- retrieval -----------------------------------------------------------

    def find_matches(self, signs, offset: int = 0, head=None,
                     max_hits: Optional[int] = None):
        """All (event, Match) occurrences as a columnar ``MatchSet``,
        ordered by end position, longest first within a position.

        With a packed k-gram table (the default) retrieval is two-phase:
        K4 emits per-gram words and counts the live grams, which size the
        refinement's buffers, so no ``max_hits`` is needed. A prefilter
        scanner retrieves through K8 over the live-block windows. Without
        a packed table, ``max_hits`` takes K8 over the whole stream.
        ``max_hits`` bounds the result and raises if more positions
        match. The span ``ac.find_matches`` notes the ``route``:
        "device" (K4 and the refinement, or K8), "sparse" (the prefilter)
        or "states" (K2's states decoded on the host)."""
        # Under the lock from the scan to the decode: refresh() swaps the
        # tables both read.
        with profiling.span("ac.find_matches") as sp, self._dispatch:
            sp.note("symbols", len(signs))
            if (max_hits is not None or self._snap.packed is not None
                    or self._prefilter != "off"):
                out = self._find_matches_device(signs, offset, head,
                                                max_hits)
            else:
                out = self._host_matchset(
                    self.scan_states(signs, head=head), offset)
            sp.note("events", len(out))
        return out

    def _host_matchset(self, states: np.ndarray, offset: int) -> MatchSet:
        """MatchSet of a full per-position state stream, decoded on the
        host: the route "states" of ``ac.find_matches``."""
        profiling.note("route", "states")
        with profiling.span("ac.decode") as sp:
            sp.note("on_device", 0)
            ends, end_states, idx = decode_matches_arrays(
                states, self.tables, offset)
            sp.note("events", len(ends))
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _empty_matches(self) -> MatchSet:
        return MatchSet(self.machine, self.tables, np.zeros(0, np.int64),
                        np.zeros(0, np.int32), np.zeros(0, np.int32))

    def _find_matches_device(self, signs, offset, head, max_hits):
        if len(signs) == 0:
            return self._empty_matches()
        raw = self._raw_stream(signs)
        if max_hits is not None:
            max_hits = int(max_hits)
        if self._prefilter != "off":
            if _is_tensor(signs):
                out = self._sparse_hits_device(signs, offset, head, max_hits)
            else:
                out = self._sparse_hits(signs, offset, head, max_hits, raw)
            if out is not None:
                profiling.note("route", "sparse")
                self._record("find_matches_sparse")
                return out
        auto = max_hits is None
        _guard_pos32(len(raw[0]) if raw is not None else len(signs))
        st, snap = self._stepped, self._snap
        with self._dispatch:
            if snap.packed is None and auto:
                # the full decode of K2's states (the prefilter declined
                # and no packed table exists)
                return self._host_matchset(
                    self.scan_states(signs, head=head), offset)
            profiling.note("route", "device")
            if snap.packed is None:
                # K8 over the whole stream: exactly the hit positions
                ext, lut, head_ids, B, L, T = self._stage(signs, raw, head,
                                                          self.halo, 128)
                self._guard_acc(L)
                positions, sts, _, _ = dense_hits(
                    snap.dflat, snap.nb_out, self.V, self.halo, B, L, ext,
                    lut, head_ids, max_hits=max_hits, **self._dense_fields())
                out = self._hits_matchset(positions, sts, T, offset)
                self._record("find_matches_device")
                return out
            ext, lut, head_ids, B, L, T = self._stage(
                signs, raw, head, self._halo_sym, 128 * st.k)
            # per-stream int32 n_hits must not wrap: the count's bound
            self._guard_acc(L)
            emit, n_hits_dev, n_live_dev = stepped_emit(
                snap.packed, st.V, st.k, st.count_bits, self._halo_steps, B,
                L, ext, lut, head_ids, warm_steps=self._emit_warm)
            n_live = int(n_live_dev.sum(dtype=torch.int64))
            profiling.note("n_live", n_live)
            if not auto and n_live > max_hits:
                raise ValueError(
                    f"at least {n_live} matching positions exceed "
                    f"max_hits={max_hits}; raise max_hits or chunk the "
                    "stream with a session")
            if n_live == 0:
                positions = torch.zeros(0, dtype=torch.int64,
                                        device=emit.device)
                sts = torch.zeros(0, dtype=torch.int32, device=emit.device)
                n_hit_pos = 0
            else:
                cap = max(8, 1 << (n_live - 1).bit_length())
                if auto:
                    # n_hit_pos <= n_hits, so this bound cannot overflow
                    n_hits = int(n_hits_dev.sum(dtype=torch.int64))
                    out_size = min(
                        cap * st.k,
                        max(8, 1 << (max(n_hits, 1) - 1).bit_length()))
                else:
                    out_size = min(max_hits, cap * st.k)
                body = ext[self._halo_sym:]
                with profiling.span("ac.refine") as rsp:
                    rsp.note("out_size", out_size)
                    # Past 1/8 live grams refining every position beats
                    # compacting the live ones (the JAX package's
                    # threshold).
                    pk1 = self._pk1()
                    if pk1 is not None and n_live * 8 > (B * L) // st.k:
                        syms = (body.long() if lut is None
                                else lookup(lut, body))
                        pk1, cb1 = pk1
                        positions, sts, n_hit_pos = hits_extract_dense(
                            st.V, st.k, st.count_bits, cb1, out_size, pk1,
                            emit, syms)
                    else:
                        positions, sts, n_hit_pos = hits_extract(
                            st.V, st.k, st.count_bits, cap, out_size, emit,
                            (lambda p: body[p].long()) if lut is None
                            else (lambda p: lookup(lut, body[p])),
                            snap.dflat, snap.nb_out)
        if not auto and n_hit_pos > max_hits:
            raise max_hits_error(n_hit_pos, max_hits)
        out = self._hits_matchset(positions, sts, T, offset)
        self._record("find_matches_device")
        return out

    def _hits_matchset(self, positions: torch.Tensor, states: torch.Tensor,
                       T: int, offset: int) -> MatchSet:
        """MatchSet of hits in stream order (the refinements' or K8's:
        ascending positions, those past the stream's T symbols and the -1
        pads last), decoded on their device; only the events' four
        columns are read back."""
        with profiling.span("ac.decode") as sp:
            sp.note("on_device", 1)
            cols = expand_hits_device(positions, states, T,
                                      self._decode_tables(), offset)
            sp.note("events", len(cols[0]))
        with profiling.span("ac.readback") as sp:
            sp.note("bytes", sum(c.nbytes for c in cols))
            ends, end_states, idx, ranks = self._stager.download(*cols)
        return MatchSet(self.machine, self.tables, ends, end_states, idx,
                        ranks)

    # -- sparse prefilter: retrieval -----------------------------------------

    def _sparse_hits(self, signs, offset, head, max_hits, raw):
        """Filter-then-extract retrieval from host input
        (``models/scanner.py:1530-1631``): raw symbols first try the raw
        filter and elision (``_elided_hits``); otherwise the host ids'
        live blocks are scanned from the uploaded stream through their
        index list, by K8's window form with 1-char windows. None when not
        applicable or the "auto" gate declines (the dense retrieval
        answers)."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        if raw is not None:
            arr, (_, n_lut, _, lut_host) = raw
            verdict, live, n_live, nB_real = sparse.raw_elision_plan(
                arr, lut_host, n_lut, self._prefilter, halo, L_blk)
            if live is not None:
                self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
            if verdict == "zero":
                return self._empty_matches()
            if verdict == "dense":
                return None
            if verdict == "elide":
                return self._elided_hits(arr, (lut_host, n_lut), len(arr),
                                         live, n_live, offset, head,
                                         nB_real, max_hits)
        ids = self.encode(signs)
        T = len(ids)
        _guard_pos32(T)
        nB_real = -(-T // L_blk)
        live = sparse.live_blocks(ids, L_blk)
        n_live = int(live.sum())
        self.stats["sparse_live_frac"] = n_live / nB_real
        if n_live == 0:
            return self._empty_matches()
        if self._declines(n_live, nB_real):
            return None
        return self._window_matches(
            *self._indexed_windows(ids, live, n_live, head, halo, L_blk), T,
            offset, max_hits)

    def _window_matches(self, src, idx, T: int, offset: int, max_hits):
        """K8 over 1-char live-block windows, and their MatchSet."""
        self._guard_acc(self.halo + 128)
        positions, sts, _, _ = window_hits(
            self._snap.dflat, self._snap.nb_out, self.V, self.halo, 128, src,
            idx, max_hits=max_hits, **self._dense_fields())
        return self._hits_matchset(positions, sts, T, offset)

    def _sparse_hits_device(self, ids: torch.Tensor, offset, head, max_hits):
        """Filter-then-extract retrieval of a letter-id tensor
        (``models/scanner.py:1633-1699``): the block filter on the device,
        one 4-byte synchronisation, and K8 over the resident order; no
        corpus upload. None when not applicable or the "auto" gate
        declines."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        T = ids.numel()
        _guard_pos32(T)
        ext, idx, n_live, nB_real = self._sparse_filter_device(ids, head,
                                                               halo, L_blk)
        if n_live == 0:
            return self._empty_matches()
        if self._declines(n_live, nB_real):
            return None
        return self._window_matches(ext, idx, T, offset, max_hits)

    def _elided_hits(self, arr, lut, T: int, live, n_live: int, offset,
                     head, nB_real: int, max_hits):
        """Bounded hits over host-elided live windows
        (``models/scanner.py:1701-1738``): only the live windows upload,
        positions come back through their block indices."""
        _guard_pos32(T)
        tm, idx = sparse.elide_windows(arr, lut, T, live, n_live, head,
                                       self.halo, 128, nB_real)
        out = self._window_matches(self._stager.upload(tm),
                                   self._stager.upload(idx.astype(np.int32)),
                                   T, offset, max_hits)
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return out

    def _pk1(self):
        """(packed k=1 table (next_state << cb1) | nb on the device, cb1)
        for the dense refinement: one gather per position. The snapshot's
        own table when step_k == 1; otherwise composed on the device from
        the snapshot's 1-char tables at first use and cached per table
        version, so a refresh invalidates it. None when it does not fit 31
        bits."""
        st = self._stepped
        if st is not None and st.k == 1 and self._snap.packed is not None:
            return self._snap.packed, st.count_bits
        ver = self.tables.version
        if self._pk1_cache is not None and self._pk1_cache[0] == ver:
            return self._pk1_cache[1]
        snap = self._snap
        S = self.tables.n_states
        cb1 = max(1, int(snap.max_nb).bit_length())
        state_bits = max(1, int(S - 1).bit_length())
        entry = None
        if state_bits + cb1 <= 31:
            entry = (compose_packed(snap.dflat.view(snap.cap, snap.V),
                                    snap.nb_out, S, 1, cb1, S), cb1)
        self._pk1_cache = (ver, entry)
        return entry

    def _decode_tables(self) -> DecodeTables:
        """The decode's tables on the device, uploaded at the first
        retrieval after a change of tables (cached per table version, as
        ``_pk1``): count() and refresh() never carry them."""
        ver = self.tables.version
        if self._dec_cache is None or self._dec_cache[0] != ver:
            self._dec_cache = (ver, DecodeTables(*(
                self._snap.place(getattr(self.tables, f))
                for f in DecodeTables._fields)))
        return self._dec_cache[1]

    def session(self) -> "StreamSession":
        """Open a chunked streaming session (exact across chunk edges)."""
        return StreamSession(self)

    def scan_states_sequential(self, signs) -> np.ndarray:
        """states[t] from one sequential scan of the whole stream from the
        root, the literal recurrence (K2 in one thread): the conformance
        oracle of the blocked scans."""
        ids = self.encode(signs)
        if len(ids) == 0:
            return np.zeros(0, dtype=np.int32)
        with self._dispatch:
            return sequential_states(
                self._snap.dflat, self.V, self._stager.upload(ids),
                n_states=self.tables.n_states).cpu().numpy()

    def _record(self, op: str) -> None:
        """The path the last public call took (``stats["last_op"]``); its
        time is the ``ac.*`` spans' (utils/profiling.py)."""
        self.stats["last_op"] = op


class StreamSession:
    """Chunked streaming scan, exact across chunk edges
    (``models/scanner.py:StreamSession``).

    Each chunk is scanned with the previous chunk's last ``_hmax`` letter
    ids as its head, so matches that span a chunk edge are found and
    counted in the chunk where they end. A checkpoint is (offset, tail ids,
    total, dictionary version): small, and exact to resume from.
    """

    def __init__(self, scanner):
        self.scanner = scanner
        self.offset = 0
        self.total = 0
        self._tail = np.zeros(0, dtype=np.int32)

    @property
    def _hmax(self) -> int:
        # Read live: a refresh() between chunks may grow the halo, and the
        # tails must keep up from then on. The chunk right after such a
        # growth carries the shorter tail, which the snapshot semantics of
        # insertion during a scan allow.
        s = self.scanner
        return max(s.halo, s._halo_sym if s._stepped is not None else 0)

    def _advance(self, signs) -> np.ndarray:
        """Return the previous tail (this chunk's head) and keep the new
        one. Only the chunk's last ``_hmax`` signs are encoded on the host;
        the chunk itself takes whichever path the scanner picks."""
        head = self._tail
        hmax = self._hmax
        n = len(signs)
        if hmax and n:
            tail_ids = np.asarray(self.scanner.encode(signs[-hmax:]),
                                  np.int32)
            joined = (np.concatenate([self._tail, tail_ids])
                      if len(self._tail) else tail_ids)
            self._tail = joined[-hmax:]
        elif not hmax:
            self._tail = self._tail[:0]
        self.offset += n
        return head

    def feed_count(self, signs) -> int:
        """Matches in the next chunk, those that span the previous chunk
        edge included."""
        head = self._advance(signs)
        n = self.scanner.count(signs, head=head) if len(signs) else 0
        self.total += n
        return n

    def feed_matches(self, signs, max_hits: Optional[int] = None):
        """Match events of the next chunk as a ``MatchSet`` with absolute
        stream positions; ``max_hits`` bounds it as in
        ``DenseScanner.find_matches``, per shard on a mesh scanner
        (``ShardedScanner.find_matches(max_hits_per_shard=...)``)."""
        offset = self.offset
        head = self._advance(signs)
        s = self.scanner
        if not len(signs):
            return MatchSet(s.machine, s.tables, np.zeros(0, np.int64),
                            np.zeros(0, np.int32), np.zeros(0, np.int32))
        key = "max_hits_per_shard" if hasattr(s, "n_dev") else "max_hits"
        out = s.find_matches(signs, offset=offset, head=head,
                             **{key: max_hits})
        self.total += len(out)
        return out

    # -- resume --------------------------------------------------------------

    def checkpoint(self) -> dict:
        return {"offset": self.offset, "tail": self._tail.copy(),
                "total": self.total, "version": self.scanner.version}

    @classmethod
    def restore(cls, scanner: DenseScanner, state: dict) -> "StreamSession":
        if state["version"] != scanner.version:
            raise ValueError("session checkpoint belongs to a different "
                             "table snapshot")
        s = cls(scanner)
        s.offset = int(state["offset"])
        s._tail = np.asarray(state["tail"], np.int32)
        s.total = int(state["total"])
        return s
