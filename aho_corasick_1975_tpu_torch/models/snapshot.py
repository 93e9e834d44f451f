"""Capacity-padded device snapshot of the dense automaton tables.

The port of ``models/snapshot.py:DeviceSnapshot``: the 1-char tables
``dflat`` [cap*V] and ``nb_out`` [cap] and the k-gram tables as int32
tensors on one explicit device: the packed table [cap*V^k], or, where
(state, count) need more than 31 bits, the two-table form ``delta_k`` and
``cnt_k`` [cap*V^k] each, as in the JAX package's single-device snapshot.
Either form is composed on the device from the uploaded 1-char tables
(ops/multistep.py); no k-gram table is made on the host.
Rows are padded to the JAX package's ``round_cap`` state capacity so that
both packages hold bit-identical tables, and so that ``refresh`` can bring
an online insertion in without changing a shape.

The device tensors are the only copy the snapshot keeps: the port reads no
host mirror, so a refresh finds what changed on the device, against the
live tables, and updates the device tables alone, in place. A mesh
scanner (parallel/sharded_scan.py) asks for a replica of every table on
each distinct device of its mesh (``devices``), and for ``packed_only``:
no two-table form, as the JAX mesh scanner's snapshot. A refresh writes
the same rows and cells into every replica.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.builder import round_cap
from ..ops import multistep
from ..ops.multistep import SteppedTables, choose_k
from ..utils import profiling


class DeviceSnapshot:
    """Device-resident tables of one ``DenseTables`` snapshot, with
    in-place incremental refresh."""

    _TABLES = ("dflat", "nb_out", "packed", "delta_k", "cnt_k")

    def __init__(self, tables, step_k="auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 device="cuda", packed_only: bool = False, devices=()):
        """``packed_only``: where the k-gram table only fits as two tables,
        keep no k-gram table (``stepped`` None, ``step_k`` as chosen), as
        the JAX snapshot's ``packed_only=True``. ``devices``: more devices
        that get a replica of every table (``replica``); ``device`` is the
        first."""
        self.device = torch.device(device)
        self.devices = [self.device]
        for d in map(torch.device, devices):
            if d not in self.devices:
                self.devices.append(d)
        self.packed_only = packed_only
        self._spec = (step_k, step_budget_bytes)
        self.last_refresh: dict = {}
        self._build(tables)

    def place(self, a: np.ndarray, device=None) -> torch.Tensor:
        """Synchronous upload of a host array to ``device`` (default: the
        snapshot's device): every table upload goes through here, the
        span ``ac.upload``."""
        with profiling.span("ac.upload") as sp:
            a = np.ascontiguousarray(a)
            sp.note("bytes", a.nbytes)
            return torch.from_numpy(a).to(
                self.device if device is None else device)

    def _table(self, a: np.ndarray) -> torch.Tensor:
        """An int32 table's own copy on the device. On the CPU ``place``
        would alias the host array, which may back the machine's
        ``DenseTables``; refresh writes into the tables in place."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(a, dtype=np.int32))
        return self.place(np.asarray(a, np.int32))

    def replica(self, device) -> dict:
        """The tables on ``device`` (one of ``devices``), by name: "dflat",
        "nb_out", "packed", "delta_k", "cnt_k" (None where absent)."""
        device = torch.device(device)
        if device == self.device:
            return {n: getattr(self, n) for n in self._TABLES}
        return self._replicas[device]

    def _replicate(self) -> None:
        """Copy every table to each further device of ``devices``."""
        self._replicas = {
            d: {n: None if getattr(self, n) is None
                else getattr(self, n).to(d, copy=True) for n in self._TABLES}
            for d in self.devices[1:]}

    # -- full (re)build ------------------------------------------------------

    def _build(self, tables) -> None:
        """The tables of ``_build_tables`` on the snapshot's device, then
        their replicas. The host work is the span ``ac.snapshot.build``,
        its uploads (``place``) its children; its note ``compose`` says
        where the k-gram table was made: "device" (either form) or
        "none"."""
        with profiling.span("ac.snapshot.build") as sp:
            self._build_tables(tables)
            if sp:
                sp.note("bytes", sum(getattr(self, n).nbytes
                                     for n in self._TABLES
                                     if getattr(self, n) is not None))
                sp.note("compose",
                        "device" if self.stepped is not None else "none")
                sp.note("k", self.step_k)
        self._replicate()

    def _build_tables(self, tables) -> None:
        """``models/snapshot.py:DeviceSnapshot._build``: the 1-char tables
        and the choice of k; the k-gram table composed on the device
        (``_compose``), packed where (state, count) fit 31 bits, else in two
        tables (none with ``packed_only``)."""
        self.tables = tables
        S = tables.n_states
        self.V = tables.vocab_size
        self.cap = round_cap(S)
        # Largest per-position match count; bounds the per-stream int32
        # accumulators (the scanner's overflow guard).
        self.max_nb = int(tables.nb_outputs.max()) if S else 0
        delta_host = tables.claim_cap_delta()
        if delta_host is None or delta_host.shape != (self.cap, self.V):
            delta_host = np.zeros((self.cap, self.V), np.int32)
            delta_host[:S] = tables.delta
        nb_host = np.zeros(self.cap, np.int32)
        nb_host[:S] = tables.nb_outputs
        self.dflat = self._table(delta_host.reshape(-1))
        self.nb_out = self._table(nb_host)
        self.stepped: Optional[SteppedTables] = None
        self.packed: Optional[torch.Tensor] = None
        self.delta_k: Optional[torch.Tensor] = None
        self.cnt_k: Optional[torch.Tensor] = None
        step_k, budget = self._spec
        V = self.V
        auto_k = step_k == "auto"
        self.step_k = choose_k(S, V, budget) if auto_k else max(1, int(step_k))
        if self.step_k == 1:
            # An explicit step_k=1 means the 1-char tables only; "auto"
            # adds the packed k=1 table when it fits the budget (never the
            # unpacked one, which would repeat the 1-char tables).
            if auto_k and self.cap * V * 4 <= budget:
                self._compose(1)
            return
        # the unpacked form needs 8 bytes an entry: lower k until it fits
        while not self._compose(self.step_k):
            if S * (V ** self.step_k) * 8 <= budget:
                break
            self.step_k -= 1
            if self.step_k == 1:
                if self.cap * V * 4 <= budget:
                    self._compose(1)
                return
        if self.stepped is None and not self.packed_only:
            self.delta_k, self.cnt_k = multistep.compose_two_tables(
                self.dflat.view(self.cap, V), self.nb_out, S, self.step_k,
                self.cap)
            self.stepped = SteppedTables(k=self.step_k, V=V, count_bits=0)

    def _compose(self, k: int) -> bool:
        """The packed k-gram table at capacity, composed on the device from
        the uploaded 1-char tables (one sync, for the largest count): False,
        and no table, where (state, count) need more than 31 bits."""
        S = self.tables.n_states
        delta = self.dflat.view(self.cap, self.V)
        count_bits = multistep.packed_count_bits(
            multistep.max_gram_count(delta, self.nb_out, S, k), S)
        if count_bits is None:
            return False
        self.packed = multistep.compose_packed(delta, self.nb_out, S, k,
                                               count_bits, self.cap)
        self.stepped = SteppedTables(k=k, V=self.V, count_bits=count_bits)
        return True

    @classmethod
    def from_arrays(cls, tables, dflat: np.ndarray, nb_out: np.ndarray,
                    packed: Optional[np.ndarray], k: int, count_bits: int,
                    device="cuda", delta_k: Optional[np.ndarray] = None,
                    cnt_k: Optional[np.ndarray] = None) -> "DeviceSnapshot":
        """A snapshot of given host arrays (capacity-padded ``dflat``,
        ``nb_out`` and, if any, the packed k-gram table or the two tables
        ``delta_k`` and ``cnt_k``), e.g. the JAX scanner's own
        (utils/convert.py). A rebuild on refresh keeps k."""
        snap = cls.__new__(cls)
        snap.device = torch.device(device)
        snap.devices = [snap.device]
        snap.packed_only = False
        snap._replicas = {}
        snap._spec = (k, 128 * 1024 * 1024)
        snap.last_refresh = {}
        snap.tables = tables
        snap.V = tables.vocab_size
        snap.cap = int(nb_out.shape[0])
        snap.max_nb = (int(tables.nb_outputs.max())
                       if tables.n_states else 0)
        snap.dflat = snap._table(dflat)
        snap.nb_out = snap._table(nb_out)
        snap.step_k = k
        snap.stepped = snap.packed = snap.delta_k = snap.cnt_k = None
        if packed is not None or delta_k is not None:
            snap.stepped = SteppedTables(k=k, V=snap.V, count_bits=count_bits)
        if packed is not None:
            snap.packed = snap._table(packed)
        elif delta_k is not None:
            snap.delta_k = snap._table(delta_k)
            snap.cnt_k = snap._table(cnt_k)
        return snap

    # -- incremental refresh ---------------------------------------------

    def refresh(self, new) -> str:
        """Apply ``new`` (a later snapshot of the same machine) in place
        (``models/snapshot.py:DeviceSnapshot.refresh``).

        Returns "noop" (same content), "inplace" (row and cell writes into
        the device tables, both k-gram tables in the two-table form), or
        "rebuild:<reason>", a full rebuild for its reason: "vocab"
        (vocabulary growth), "cap" (state capacity), "count_bits" (the
        packed entry's width), or "delta" (a delta past a quarter of the
        k-gram table). The diff runs on the snapshot's device: ``new``'s
        1-char tables are uploaded once and compared with the live tables'
        first rows, which hold the old version, and the changed rows and
        k-gram cells and their new values are found there
        (``ops/multistep.py:GramDelta``), with one host sync for their
        sizes and largest count; all of it is the span ``ac.refresh.diff``
        (notes ``on_device`` 1 and ``bytes``, the upload). The writes are
        enqueued on the device's current stream; the caller serialises
        this against scans (the scanner's dispatch lock), so a scan on that
        stream sees either the old tables or the new ones."""
        t0 = time.perf_counter()
        self.last_refresh = {}
        if new.vocab_size != self.V:
            return self._rebuild(new, "vocab")
        if new.n_states > self.cap:
            return self._rebuild(new, "cap")

        S_old, S_new, V = self.tables.n_states, new.n_states, self.V
        st = self.stepped
        with profiling.span("ac.refresh.diff") as sp:
            d_new = self.place(new.delta)
            nb_new = self.place(new.nb_outputs)
            sp.note("on_device", 1)
            sp.note("bytes", new.delta.nbytes + new.nb_outputs.nbytes)
            diff = multistep.GramDelta(
                self.dflat[:S_old * V].view(S_old, V), self.nb_out[:S_old],
                d_new, nb_new, None if st is None else st.k)
            n_rows, n_cells, max_cnt = diff.sizes()
            sp.note("rows", n_rows)
            if not n_rows:
                self.tables = new
                return "noop"
            rebuild = None
            if st is not None:
                sp.note("cells", n_cells)
                # Past a quarter of the table a rebuild beats the scatter
                # (the JAX package's measured rule); below 64k cells stay
                # in place.
                if n_cells > max(S_new * st.Vk // 4, 1 << 16):
                    rebuild = "delta"
                elif self.packed is not None:
                    state_bits = max(1, int(S_new - 1).bit_length())
                    if (max_cnt.bit_length() > st.count_bits
                            or state_bits + st.count_bits > 31):
                        rebuild = "count_bits"
            if rebuild is None:
                rows = diff.rows()
                writes = [("dflat", rows, d_new.index_select(0, rows), V),
                          ("nb_out", rows, nb_new.index_select(0, rows), 1)]
                if st is not None:
                    cells, land, cnt = diff.cells()
                    if self.packed is not None:
                        writes.append(("packed", cells, (
                            (land.long() << st.count_bits) | cnt).int(), 1))
                    else:
                        writes += [("delta_k", cells, land, 1),
                                   ("cnt_k", cells, cnt.int(), 1)]
        if rebuild is not None:
            return self._rebuild(new, rebuild)

        for name, index, vals, width in writes:
            for d in self.devices:
                self.replica(d)[name].view(-1, width).index_copy_(
                    0, index.to(d), vals.to(d).view(-1, width))
        self.tables = new
        self.max_nb = int(new.nb_outputs.max()) if S_new else 0
        self.last_refresh = {"rows": n_rows, "cells": n_cells,
                             "seconds": time.perf_counter() - t0}
        return "inplace"

    def _rebuild(self, new, reason: str) -> str:
        self._build(new)
        return f"rebuild:{reason}"
