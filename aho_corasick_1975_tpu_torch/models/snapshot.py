"""Capacity-padded device snapshot of the dense automaton tables.

The port of ``models/snapshot.py:DeviceSnapshot``, build only: the 1-char
tables ``dflat`` [cap*V] and ``nb_out`` [cap] and the packed k-gram table
[cap*V^k] as int32 tensors on one explicit device. Rows are padded to the
JAX package's ``round_cap`` state capacity so that both packages hold
bit-identical tables. In-place refresh is not ported yet (ROADMAP A.8).

Where (state, count) need more than 31 bits the k-gram table would take
the JAX package's two-table unpacked form; the port drops it instead and
counts through the 1-char tables (the JAX mesh scanner's ``packed_only``
rule).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._host import round_cap
from ..ops.multistep import SteppedTables, build_stepped, choose_k


class DeviceSnapshot:
    """Device-resident tables of one ``DenseTables`` snapshot."""

    def __init__(self, tables, step_k="auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 device="cuda"):
        self.device = torch.device(device)
        self.tables = tables
        S = tables.n_states
        self.V = tables.vocab_size
        self.cap = round_cap(S)
        # Largest per-position match count; bounds the per-stream int32
        # accumulators (the scanner's overflow guard).
        self.max_nb = int(tables.nb_outputs.max()) if S else 0
        buf = tables.claim_cap_delta()
        if buf is not None and buf.shape == (self.cap, self.V):
            delta_host = buf
        else:
            delta_host = np.zeros((self.cap, self.V), np.int32)
            delta_host[:S] = tables.delta
        nb_host = np.zeros(self.cap, np.int32)
        nb_host[:S] = tables.nb_outputs
        self.dflat = self.place(delta_host.reshape(-1))
        self.nb_out = self.place(nb_host)
        self.stepped: Optional[SteppedTables] = None
        self.packed: Optional[torch.Tensor] = None
        self._build_stepped(step_k, step_budget_bytes)

    def place(self, a: np.ndarray) -> torch.Tensor:
        """Synchronous upload of a host array to the snapshot's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _build_stepped(self, step_k, budget: int) -> None:
        """``models/snapshot.py:DeviceSnapshot._build``'s choice of k, with
        ``packed_only``."""
        tables = self.tables
        S, V = tables.n_states, self.V
        auto_k = step_k == "auto"
        self.step_k = choose_k(S, V, budget) if auto_k else max(1, int(step_k))
        if self.step_k == 1:
            # An explicit step_k=1 means the 1-char tables only; "auto"
            # adds the packed k=1 table when it fits the budget.
            if auto_k and self.cap * V * 4 <= budget:
                self._adopt(build_stepped(tables, 1, cap_rows=self.cap))
            return
        st = build_stepped(tables, self.step_k, cap_rows=self.cap)
        # the unpacked form needs 8 bytes an entry: lower k until it fits
        while (st is not None and st.packed is None and self.step_k > 1
               and S * (V ** st.k) * 8 > budget):
            self.step_k -= 1
            st = (build_stepped(tables, self.step_k, cap_rows=self.cap)
                  if self.step_k > 1 else None)
        if st is None or self.step_k <= 1:
            self.step_k = max(1, self.step_k)
            if self.step_k == 1 and self.cap * V * 4 <= budget:
                self._adopt(build_stepped(tables, 1, cap_rows=self.cap))
            return
        self._adopt(st)

    def _adopt(self, st: SteppedTables) -> None:
        if st.packed is None:
            return
        if (st.cap_packed is not None
                and st.cap_packed.size == self.cap * st.Vk):
            host = st.cap_packed
        else:
            host = np.zeros(self.cap * st.Vk, np.int32)
            host[:st.packed.size] = st.packed
        self.stepped = st
        self.packed = self.place(host)

    @classmethod
    def from_arrays(cls, tables, dflat: np.ndarray, nb_out: np.ndarray,
                    packed: Optional[np.ndarray], k: int, count_bits: int,
                    device="cuda") -> "DeviceSnapshot":
        """A snapshot of given host arrays (capacity-padded ``dflat``,
        ``nb_out`` and, if any, the packed k-gram table), e.g. the JAX
        scanner's own (utils/convert.py)."""
        snap = cls.__new__(cls)
        snap.device = torch.device(device)
        snap.tables = tables
        snap.V = tables.vocab_size
        snap.cap = int(nb_out.shape[0])
        snap.max_nb = (int(tables.nb_outputs.max())
                       if tables.n_states else 0)
        snap.dflat = snap.place(np.array(dflat, np.int32))
        snap.nb_out = snap.place(np.array(nb_out, np.int32))
        snap.step_k = k
        snap.stepped = snap.packed = None
        if packed is not None:
            packed = np.array(packed, np.int32)
            snap.stepped = SteppedTables(k=k, V=snap.V, count_bits=count_bits,
                                         packed=packed)
            snap.packed = snap.place(packed)
        return snap
