"""The flagship model: a generic-alphabet Aho–Corasick machine.

The port's copy of ``aho_corasick_1975_tpu/models/machine.py``:
``scanner()`` imports ``.scanner``, which here is the port's scanner, and
``insert_keywords`` and ``compile`` are spans of utils/profiling.py
(``ac.insert`` and its ``ac.insert.vocab``; ``ac.compile`` when it
emits).

Public object-API equivalent of the reference's 12 exported symbols
(aho_corasick.h:45-98; see also the thin functional shim in ``api.py``):

==============================  ==========================================
reference (aho_corasick.h)      here
==============================  ==========================================
acm_create                      Machine(...)
acm_initiate                    Machine.initiate()
acm_insert_letter_of_keyword    Machine.insert_letter_of_keyword(cur, sign)
acm_insert_end_of_keyword       Machine.insert_end_of_keyword(cur, value)
acm_match                       Machine.match(cur, sign)
acm_matcher_init                Match (plain value object; no init needed)
acm_get_match                   Machine.get_match(cur, index)
acm_matcher_release             (garbage collected)
acm_nb_keywords                 Machine.nb_keywords()
acm_foreach_keyword             Machine.foreach_keyword(fn)
acm_print                       Machine.print(stream, printer)
acm_release                     (garbage collected)
==============================  ==========================================

Beyond parity, the machine exposes the TPU path: ``compile()`` emits an
immutable dense-table snapshot (``DenseTables``) that the scanners in
``models/scanner.py`` upload and scan on device. Snapshots are versioned:
keywords inserted after a ``compile()`` are visible to the *next* snapshot
only — the TPU consistency model for the reference's insert-during-scan
feature (README.md:352-356; see SURVEY.md §7 "Insert-during-scan semantics").
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, IO, List, Optional

from ..core.builder import Builder, DenseTables, ROOT
from ..utils import profiling
from ..utils.vocab import Vocab


@dataclass
class Match:
    """A retrieved match (reference MatchHolder, aho_corasick.h:23-28)."""

    letters: List[Any]   # signs of the matched keyword, in order
    value: Any = None    # user value associated at insert_end time
    rank: int = -1       # unique keyword rank (insertion order)

    @property
    def length(self) -> int:
        return len(self.letters)

    def text(self) -> str:
        """Convenience for string alphabets."""
        return "".join(str(s) for s in self.letters)


class Cursor:
    """Opaque streaming cursor (reference ACState*, advanced in place)."""

    __slots__ = ("machine", "state")

    def __init__(self, machine: "Machine", state: int = ROOT):
        self.machine = machine
        self.state = state


class Machine:
    """Generic-alphabet multi-pattern matcher.

    Parameters
    ----------
    key_fn:
        Maps a sign to a key; two signs are the same letter iff keys are
        equal. With the default id map the key must be hashable and
        orderable. Default: identity.
    cmp_fn:
        Total-order comparator ``cmp(a, b) -> <0 / 0 / >0`` over keys —
        the reference's exact genericity contract (``cmp``/``cmp_arg``,
        aho_corasick.h:33-38): keys need NOT be hashable, only
        comparator-orderable; two signs are the same letter iff
        cmp(key(a), key(b)) == 0. Per-sign cost is O(log vocab) instead
        of O(1). Omit for hashable keys (the fast default).
    incremental:
        True → Meyer-1985 incremental fail maintenance (reference default);
        False → AC75 lazy BFS reconstruction (reference ``-DNMEYER_85``).
    """

    def __init__(self, key_fn: Optional[Callable[[Any], Any]] = None,
                 incremental: bool = True, backend: str = "auto",
                 cmp_fn: Optional[Callable[[Any, Any], int]] = None):
        self.vocab = Vocab(key_fn, cmp_fn=cmp_fn)
        self._b = _make_backend(backend, incremental)
        self.incremental = incremental
        self._values: dict[int, Any] = {}   # end-state -> user value
        # Machine-wide insertion lock — the Python-level equivalent of the
        # reference's machine mutex (aho_corasick.c:81, taken in both insert
        # calls c:295,344). It makes (vocab registration, builder insert,
        # value adoption) atomic, and compile() snapshots (vocab_size,
        # tables) under the same lock, so a concurrent insert can never land
        # between the vocab-size read and the table emission. Match and
        # lookup paths stay lock-free, like the reference's scan (c:433).
        self._lock = threading.RLock()
        self._compiled: Optional[DenseTables] = None

    # -- lifecycle / cursors ----------------------------------------------

    def initiate(self) -> Cursor:
        """ref acm_initiate (c:161-165)."""
        return Cursor(self, ROOT)

    # -- insertion ---------------------------------------------------------

    def insert_letter_of_keyword(self, cursor: Cursor, sign: Any) -> None:
        """ref acm_insert_letter_of_keyword (c:291-316)."""
        with self._lock:
            letter = self.vocab.register(sign)
            cursor.state = self._b.insert_letter(cursor.state, letter)

    def insert_end_of_keyword(self, cursor: Cursor, value: Any = None) -> Any:
        """ref acm_insert_end_of_keyword (c:340-363).

        Returns the previously-associated value if the keyword already had
        one (the caller may merge, README.md:182-189), else None. The value
        is adopted only when the state holds none (first-writer-wins,
        c:357-359). Resets the cursor to the root (c:360).
        """
        with self._lock:
            state = cursor.state
            self._b.insert_end(state)
            prev = self._values.get(state)
            if prev is None and value is not None:
                self._values[state] = value
            cursor.state = ROOT
            return prev

    def insert_keyword(self, signs, value: Any = None) -> Any:
        """Convenience: insert a whole keyword (sequence of signs).

        Uses the native bulk path when available (one FFI call per keyword
        instead of one per sign); semantics identical to the per-sign loop."""
        with self._lock:
            ids = [self.vocab.register(s) for s in signs]
            if not ids:
                raise ValueError("empty keyword (ref c:345)")
            b = self._b
            if hasattr(b, "insert_keywords_bulk"):
                import numpy as np
                ends, _ = b.insert_keywords_bulk(
                    np.asarray(ids, np.int32),
                    np.asarray([0, len(ids)], np.int64))
                end = int(ends[0])
                prev = self._values.get(end)
                if prev is None and value is not None:
                    self._values[end] = value
                return prev
            cur = self.initiate()
            for letter in ids:
                cur.state = b.insert_letter(cur.state, letter)
            return self.insert_end_of_keyword(cur, value)

    def insert_keywords(self, keywords, values: Optional[List[Any]] = None
                        ) -> List[Any]:
        """Bulk-register many keywords; returns the previous value per
        keyword (None where fresh), following the duplicate protocol."""
        with profiling.span("ac.insert") as sp, self._lock:
            with profiling.span("ac.insert.vocab"):
                id_lists = [[self.vocab.register(s) for s in kw]
                            for kw in keywords]
            if sp:
                sp.note("keywords", len(id_lists))
                sp.note("letters", sum(map(len, id_lists)))
            return self._insert_keywords_locked(id_lists, values)

    def _insert_keywords_locked(self, id_lists, values):
        if any(not ids for ids in id_lists):
            raise ValueError("empty keyword (ref c:345)")
        b = self._b
        prevs: List[Any] = []
        if hasattr(b, "insert_keywords_bulk"):
            import numpy as np
            flat = np.asarray([i for ids in id_lists for i in ids], np.int32)
            offsets = np.zeros(len(id_lists) + 1, np.int64)
            np.cumsum([len(ids) for ids in id_lists], out=offsets[1:])
            ends, _ = b.insert_keywords_bulk(flat, offsets)
            for j, end in enumerate(ends.tolist()):
                prev = self._values.get(end)
                val = values[j] if values is not None else None
                if prev is None and val is not None:
                    self._values[end] = val
                prevs.append(prev)
            return prevs
        for j, ids in enumerate(id_lists):
            cur = self.initiate()
            for letter in ids:
                cur.state = b.insert_letter(cur.state, letter)
            prevs.append(self.insert_end_of_keyword(
                cur, values[j] if values is not None else None))
        return prevs

    # -- streaming match (host path) ---------------------------------------

    def match(self, cursor: Cursor, sign: Any) -> int:
        """One streaming match step; returns the number of keywords ending at
        this symbol (ref acm_match c:433-448)."""
        letter = self.vocab.lookup(sign)
        cursor.state, nb = self._b.match(cursor.state, letter)
        return nb

    def match_stream(self, cursor: Cursor, signs,
                     parallel: Optional[bool] = None) -> int:
        """Advance the cursor through a whole chunk of signs and return the
        total number of matches — the host streaming path at native speed
        (one FFI call per chunk instead of one per sign). Equivalent to
        summing acm_match over the chunk (ref c:433-448); per-position
        events need the device scanner or the per-sign loop.

        ``parallel``: halo-blocked threaded scan (the host mirror of the
        device kernel's sequence parallelism, ops/blocking.py — exact by
        the same suffix-property argument, native backend only). None =
        auto: threads kick in for streams past ~1M symbols."""
        import numpy as np
        ids = np.asarray(self.vocab.lookup_many(signs), np.int32)
        b = self._b
        if hasattr(b, "match_stream_threaded") and (
                parallel or (parallel is None and len(ids) >= 1 << 20)):
            cursor.state, total = b.match_stream_threaded(cursor.state, ids)
            return total
        if hasattr(b, "match_bulk"):
            cursor.state, total = b.match_bulk(cursor.state, ids)
            return total
        total = 0
        s = cursor.state
        for letter in ids.tolist():
            s, n = b.match(s, int(letter))
            total += n
        cursor.state = s
        return total

    def match_stream_many(self, docs) -> "np.ndarray":
        """Per-document match counts for a batch of independent sign
        sequences on the HOST, threaded across cores (native backend; the
        host analogue of DenseScanner.count_many). Each document starts at
        the root. Returns an int64 array of len(docs) counts."""
        import numpy as np
        encoded = [np.asarray(self.vocab.lookup_many(d), np.int32)
                   for d in docs]
        if not encoded:
            return np.zeros(0, np.int64)
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        flat = (np.concatenate(encoded) if offsets[-1]
                else np.zeros(0, np.int32))
        b = self._b
        if hasattr(b, "match_bulk_many"):
            totals, _ = b.match_bulk_many(flat, offsets)
            return totals
        out = np.zeros(len(encoded), np.int64)
        for d, ids in enumerate(encoded):
            s, tot = 0, 0
            for letter in ids.tolist():
                s, n = b.match(s, int(letter))
                tot += n
            out[d] = tot
        return out

    def get_match(self, cursor: Cursor, index: int) -> Match:
        """index-th match at the current cursor position, index 0 = longest
        (ref acm_get_match c:450-482)."""
        end = self._b.get_match_state(cursor.state, index)
        return self.match_for_state(end)

    def match_for_state(self, end_state: int) -> Match:
        """Materialize the keyword ending at ``end_state`` (backward
        reconstruction via previous links, ref c:471-480)."""
        letters = self.vocab.signs(self._b.keyword_letters(end_state))
        return Match(letters=letters, value=self._values.get(end_state),
                     rank=self._b.kw_rank_of(end_state))

    # -- introspection ------------------------------------------------------

    def nb_keywords(self) -> int:
        """ref acm_nb_keywords (c:484-488)."""
        return self._b.nb_sequences

    def foreach_keyword(self, fn: Callable[[Match], None]) -> None:
        """DFS enumeration in comparator(key) order
        (ref acm_foreach_keyword c:521-531)."""
        for end, letter_ids in self._b.iter_keywords(self.vocab.sort_key):
            fn(Match(letters=self.vocab.signs(letter_ids),
                     value=self._values.get(end),
                     rank=self._b.kw_rank_of(end)))

    def keywords(self) -> List[Match]:
        out: List[Match] = []
        self.foreach_keyword(out.append)
        return out

    def print(self, stream: Optional[IO[str]] = None,
              printer: Optional[Callable[[Any], str]] = None) -> None:
        """ASCII trie dump (ref acm_print c:583-594); format parity with the
        reference, see utils/dump.py."""
        from ..utils.dump import print_machine
        print_machine(self, stream or sys.stdout, printer)

    @property
    def n_states(self) -> int:
        return self._b.n_states

    @property
    def version(self) -> int:
        return self._b.version

    def value_of_state(self, state: int) -> Any:
        return self._values.get(state)

    # -- TPU path -----------------------------------------------------------

    def compile(self) -> DenseTables:
        """Emit an immutable dense-table snapshot of the current dictionary.

        This is the host→device boundary: the whole goto/fail machinery
        (reference call stack §3.2 of SURVEY.md) is collapsed into a single
        total transition table; scanning becomes a gather recurrence.

        Thread-safe against concurrent insertion: the snapshot of
        (vocab_size, builder tables) is taken under the machine lock, the
        same exclusion the reference's BFS reconstruction uses
        (double-checked ``reconstruct`` under the mutex, c:389-394).
        """
        with self._lock:
            # Version cache: scanners call compile() on every refresh() to
            # learn whether anything changed — at pod-dictionary scale a
            # full emit is seconds of page faults, so a no-change compile
            # must be free. The cached snapshot is keyed on (dictionary
            # version, vocab size); states created by a keyword whose end
            # was not yet inserted carry no outputs, so serving the cached
            # snapshot then is exactly the documented consistency model
            # (keywords become visible at the NEXT snapshot).
            c = self._compiled
            if (c is not None and c.version == self._b.version
                    and c.vocab_size == self.vocab.size):
                return c
            with profiling.span("ac.compile") as sp:
                tabs = self._b.emit_tables(vocab_size=self.vocab.size)
                sp.note("states", tabs.n_states)
            self._compiled = tabs
            return tabs

    def scanner(self, **kwargs):
        """Build a device scanner over the current snapshot
        (models/scanner.py)."""
        from .scanner import DenseScanner
        return DenseScanner(self, **kwargs)


def _make_backend(backend: str, incremental: bool):
    if backend in ("auto", "native"):
        try:
            from ..core.native import NativeBuilder
            return NativeBuilder(incremental)
        except Exception:
            if backend == "native":
                raise
    return Builder(incremental)
