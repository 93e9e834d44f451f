"""Columnar match results — C-speed retrieval at TPU-scale match counts.

The port's copy of ``aho_corasick_1975_tpu/models/results.py``; the lazy
columns' gathers are ``ac.decode`` spans (utils/profiling.py). A retrieval
decoded on the device hands ``ranks`` in with the other columns.

The reference streams matches one at a time through ``acm_get_match``
(aho_corasick.c:450-482): a fail-chain walk plus a backward
``previous``-link reconstruction per retrieved keyword, at C speed. An
earlier version materialized one Python ``MatchEvent`` + ``Match`` object
per occurrence — minutes of interpreter time at the headline corpus's ~10M
matches. ``MatchSet`` replaces that with the columnar representation the
decode kernels already produce internally:

* ``ends`` / ``starts`` / ``end_states`` / ``indices`` / ``lengths`` /
  ``ranks`` are numpy arrays over ALL events (zero per-event Python);
* the list-of-(event, Match) API is preserved lazily: ``MatchSet`` is a
  ``Sequence`` whose elements are built on access, with one cached ``Match``
  per distinct keyword (end state) — iterating a 10M-event set touches the
  keyword-reconstruction path only ~n_keywords times.

Event order: ascending end position; within a position index 0 = longest
keyword (the reference's acm_get_match index order, c:459-466).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ..ops.decode import MatchEvent
from ..utils import profiling


class MatchSet(Sequence):
    """Columnar (event, Match) sequence returned by ``find_matches``.

    Behaves like a list — iteration yields ``(MatchEvent, Match)``
    tuples, ``len``/indexing/slicing/equality-with-list all work — while the
    bulk data stays in numpy arrays:

    ``ends``        int64 [E]  end position of each occurrence
    ``end_states``  int32 [E]  automaton end state (identifies the keyword)
    ``indices``     int32 [E]  per-position match index (0 = longest)
    ``lengths``     int32 [E]  keyword length
    ``starts``      int64 [E]  ends - lengths + 1
    ``ranks``       int32 [E]  keyword rank (insertion order); given to
                               the constructor by a retrieval decoded on
                               the device, else gathered on first read
    """

    __slots__ = ("machine", "tables", "ends", "end_states", "indices",
                 "_lengths", "_starts", "_ranks", "_match_cache")

    def __init__(self, machine, tables, ends: np.ndarray,
                 end_states: np.ndarray, indices: np.ndarray,
                 ranks: Optional[np.ndarray] = None):
        self.machine = machine
        self.tables = tables
        self.ends = np.asarray(ends, np.int64)
        self.end_states = np.asarray(end_states, np.int32)
        self.indices = np.asarray(indices, np.int32)
        self._lengths = None
        self._starts = None
        self._ranks = None if ranks is None else np.asarray(ranks, np.int32)
        self._match_cache: dict = {}

    # -- columnar views ------------------------------------------------------

    @property
    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            with profiling.span("ac.decode") as sp:
                sp.note("events", len(self))
                self._lengths = self.tables.depth[self.end_states]
        return self._lengths

    @property
    def starts(self) -> np.ndarray:
        if self._starts is None:
            lengths = self.lengths
            with profiling.span("ac.decode") as sp:
                sp.note("events", len(self))
                self._starts = self.ends - lengths + 1
        return self._starts

    @property
    def ranks(self) -> np.ndarray:
        """Keyword rank per event (insertion order id of the keyword)."""
        if self._ranks is None:
            with profiling.span("ac.decode") as sp:
                sp.note("events", len(self))
                self._ranks = self.tables.kw_rank[self.end_states]
        return self._ranks

    def match_for(self, end_state: int):
        """The (cached) Match for a keyword end state."""
        m = self._match_cache.get(end_state)
        if m is None:
            m = self.machine.match_for_state(end_state)
            self._match_cache[end_state] = m
        return m

    def matches(self) -> List[Any]:
        """One Match per distinct keyword occurring in this set, ordered by
        first occurrence."""
        seen = dict.fromkeys(self.end_states.tolist())
        return [self.match_for(s) for s in seen]

    def values(self) -> List[Any]:
        """Per-event user values (insert-time values; None where absent)."""
        return [self.match_for(s).value for s in self.end_states.tolist()]

    # -- sequence protocol ----------------------------------------------------

    def __len__(self) -> int:
        return int(self.ends.shape[0])

    def _event(self, i: int):
        e = int(self.ends[i])
        length = int(self.lengths[i])
        s = int(self.end_states[i])
        ev = MatchEvent(end=e, start=e - length + 1, end_state=s,
                        index=int(self.indices[i]))
        return ev, self.match_for(s)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._event(j) for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._event(i)

    def __iter__(self):
        ends = self.ends.tolist()
        lengths = self.lengths.tolist()
        states = self.end_states.tolist()
        idx = self.indices.tolist()
        mf = self.match_for
        for e, ln, s, i in zip(ends, lengths, states, idx):
            yield MatchEvent(e, e - ln + 1, s, i), mf(s)

    def __eq__(self, other):
        if isinstance(other, MatchSet):
            return (np.array_equal(self.ends, other.ends)
                    and np.array_equal(self.end_states, other.end_states)
                    and np.array_equal(self.indices, other.indices))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"MatchSet({len(self)} events)"
