"""Host-side Aho–Corasick automaton builder (pure-Python backend).

The port's copy of ``aho_corasick_1975_tpu/core/builder.py``, unchanged.

Re-implements, from scratch and over a *dense integer alphabet*, the semantics
of the reference C library (``aho_corasick.c``):

* goto-graph construction by streamed insertion
  (ref: acm_insert_letter_of_keyword, aho_corasick.c:291-316, enter_child c:242-267),
* keyword finalization and output-set bookkeeping
  (ref: acm_insert_end_of_keyword c:340-363, enter_output c:330-338),
* failure-function construction in two modes:
  - **Meyer 1985 incremental** — fail links and output counts maintained on
    every insertion via inverse-fail-link (IF) propagation
    (ref: complete_fail_state c:194-208, update_fail_state c:211-222,
    complete_inverse_one_ifs c:224-239),
  - **AC75** — lazy full BFS reconstruction before the next match
    (ref: state_fail_state_construct c:386-417),
* the streaming match recurrence with the root LOOP_0 simulation
  (ref: state_goto c:167-192, acm_match c:433-448),
* match retrieval along the fail chain, index 0 = longest match
  (ref: acm_get_match c:450-482).

Design difference from the reference (deliberate, TPU-first): the reference
keeps letters generic (``void*`` + user comparator) all the way down and pays a
map lookup per symbol. Here genericity is resolved *above* this module by a
vocabulary map (``utils/vocab.py``); the builder operates on dense ``int``
letter ids so that the automaton can be emitted as dense ``int32`` tables for
the TPU scan kernels (``ops/``). Letter id 0 is reserved for OOV ("letter not
in any keyword"), which behaves exactly like an undefined transition from the
root (reference modification [3], README.md:347).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

ROOT = 0
OOV = 0  # reserved dense letter id: not part of any keyword
NO_STATE = -1

_CAP_CLAIM_LOCK = threading.Lock()


def round_cap(n: int) -> int:
    """State capacity with headroom: ~n/8 rounded up to a unit of
    max(1024, n/8), always leaving at least one unit of free growth.

    Device tables are allocated at capacity so that Meyer-mode growth
    (models/scanner.py:DenseScanner.refresh) updates rows in place —
    stable array shapes, no XLA recompile — until the dictionary outgrows
    the ~12.5% headroom."""
    unit = max(1024, n >> 3)
    return (n // unit + 1) * unit


@dataclass
class DenseTables:
    """Dense, device-uploadable automaton snapshot.

    The runtime scan needs only ``delta`` and ``nb_outputs``; the remaining
    arrays support match decoding (position, keyword) and introspection.
    State ids equal reference state UIDs (creation order), so debug dumps are
    comparable 1:1 with the reference's ``acm_print`` (c:583-594).
    """

    delta: np.ndarray        # int32 [S, V] fail-collapsed transition table
    nb_outputs: np.ndarray   # int32 [S]  |output(s)| (ref c:55)
    fail: np.ndarray         # int32 [S]  failure function (root = 0)
    depth: np.ndarray        # int32 [S]  trie depth == matched keyword length
    is_end: np.ndarray       # bool  [S]
    kw_rank: np.ndarray      # int32 [S]  keyword rank for end states else -1
    prev_state: np.ndarray   # int32 [S]  previous-state backlink (ref c:49-52)
    prev_letter: np.ndarray  # int32 [S]  letter id on the incoming edge
    emit_start: np.ndarray   # int32 [S+1] CSR offsets into emit_state
    emit_state: np.ndarray   # int32 [E]  end-states along fail chain, longest first
    version: int             # machine.reconstruct-style snapshot version
    n_keywords: int
    # Capacity-padded backing buffer of ``delta`` ([round_cap(S), V];
    # ``delta`` is its first-S-rows view), emitted by the native backend so
    # a DeviceSnapshot can adopt it without a second first-touch + copy of
    # the whole table (~70 MB/s page faults on small hosts). Claimed at
    # most once via claim_cap_delta(); None for the pure-Python backend.
    cap_delta: Optional[np.ndarray] = None

    def claim_cap_delta(self) -> Optional[np.ndarray]:
        """Transfer ownership of the capacity buffer to the caller (one
        claimant only — later claimants copy ``delta`` instead). The
        claimant may rewrite rows in place on refresh, so it must be the
        component that supersedes this snapshot's delta anyway."""
        with _CAP_CLAIM_LOCK:
            buf, self.cap_delta = self.cap_delta, None
        return buf

    @property
    def n_states(self) -> int:
        return int(self.delta.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.delta.shape[1])

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.depth.size else 0


class Builder:
    """Mutable goto/fail automaton over dense letter ids.

    ``incremental=True`` selects Meyer-1985 maintenance (reference default);
    ``False`` selects the pure AC75 lazy-BFS variant (reference ``-DNMEYER_85``).
    Both must produce identical automata — tested in
    tests/test_meyer_equivalence.py (the reference's implicit oracle, §4 of
    SURVEY.md).
    """

    def __init__(self, incremental: bool = True):
        self.incremental = incremental
        # Structure-of-arrays state storage (ref struct _ac_state, c:44-65).
        self.transitions: List[Dict[int, int]] = []
        self.fail: List[int] = []
        self.prev_state: List[int] = []
        self.prev_letter: List[int] = []
        self.is_end: List[bool] = []
        self.nb_outputs: List[int] = []
        self.depth: List[int] = []
        self.kw_rank: List[int] = []
        # Meyer IF = f^-1 record (ref c:62-64).
        self.inverse_fail: List[Set[int]] = []
        self.nb_sequences = 0      # ref machine->nb_sequences (c:69)
        self.reconstruct = 0       # dirty counter (ref c:70); also snapshot version
        self.version = 0           # total end-of-keyword insertions, for snapshots
        self.max_letter = 0        # largest dense letter id seen in a keyword
        self._lock = threading.RLock()  # ref machine->token (c:81)
        self._new_state()  # state 0 (ref acm_create c:140-151)

    # -- state lifecycle ---------------------------------------------------

    def _new_state(self) -> int:
        s = len(self.transitions)
        self.transitions.append({})
        self.fail.append(ROOT if s else NO_STATE)  # root has no fail (ref c:579)
        self.prev_state.append(NO_STATE)
        self.prev_letter.append(OOV)
        self.is_end.append(False)
        self.nb_outputs.append(0)
        self.depth.append(0)
        self.kw_rank.append(-1)
        self.inverse_fail.append(set())
        return s

    @property
    def n_states(self) -> int:
        return len(self.transitions)

    # -- goto construction (Algorithm 2) -----------------------------------

    def insert_letter(self, state: int, letter: int) -> int:
        """Advance the insertion cursor by one letter, creating a child if
        needed (ref acm_insert_letter_of_keyword c:291-316)."""
        if letter <= OOV:
            raise ValueError("letter ids must be >= 1 (0 is reserved for OOV)")
        with self._lock:
            nxt = self.transitions[state].get(letter)
            if nxt is not None:
                return nxt
            return self._enter_child(state, letter)

    def _enter_child(self, n: int, c: int) -> int:
        # ref enter_child (c:242-267)
        nprime = self._new_state()
        self.transitions[n][c] = nprime
        self.prev_state[nprime] = n
        self.prev_letter[nprime] = c
        self.depth[nprime] = self.depth[n] + 1
        if c > self.max_letter:
            self.max_letter = c
        if self.incremental:
            self._complete_fail_state(n, nprime, c)
            self.inverse_fail[self.fail[nprime]].add(nprime)
            self._complete_inverse(n, nprime, c)
        return nprime

    def _complete_fail_state(self, r: int, s: int, a: int) -> None:
        # ref complete_fail_state (c:194-208), incl. the r == root correction
        # Meyer-85 misses (c:203-205).
        if r == ROOT:
            self.fail[s] = ROOT
        else:
            self.fail[s] = self._goto_existing(self.fail[r], a)
        self.nb_outputs[s] += self.nb_outputs[self.fail[s]]

    def _complete_inverse(self, n: int, nprime: int, c: int) -> None:
        # ref complete_inverse_one_ifs (c:224-239) + update_fail_state
        # (c:211-222), iterative to avoid Python recursion limits on deep
        # suffix chains.
        stack = list(self.inverse_fail[n])
        while stack:
            x = stack.pop()
            xprime = self.transitions[x].get(c)
            if xprime is not None:
                # n' is now the longest proper suffix of x': re-point f.
                self.inverse_fail[self.fail[xprime]].discard(xprime)
                self.fail[xprime] = nprime
                self.inverse_fail[nprime].add(xprime)
            else:
                stack.extend(self.inverse_fail[x])

    def insert_end(self, state: int) -> bool:
        """Mark ``state`` as end-of-keyword (ref acm_insert_end_of_keyword
        c:340-363). Returns True if the keyword is new."""
        with self._lock:
            if state == ROOT:
                raise ValueError("insert_letter must be called first "
                                 "(ref c:345)")
            self.version += 1
            if self.is_end[state]:
                return False
            self._enter_output(state)
            self.is_end[state] = True
            self.kw_rank[state] = self.nb_sequences
            self.nb_sequences += 1
            self.reconstruct += 1
            return True

    def _enter_output(self, n: int) -> None:
        # ref enter_output (c:330-338): bump own count; in Meyer mode
        # propagate +1 over the transitive IF closure (every state whose fail
        # chain passes through n).
        if not self.incremental:
            self.nb_outputs[n] += 1
            return
        stack = [n]
        while stack:
            s = stack.pop()
            self.nb_outputs[s] += 1
            stack.extend(self.inverse_fail[s])

    # -- failure construction, AC75 mode (Algorithm 3) ---------------------

    def set_version(self, v: int) -> None:
        """Restore the snapshot-version counter (checkpoint replay)."""
        self.version = int(v)

    def ensure_fail_states(self) -> None:
        """AC75 lazy full reconstruction (ref state_fail_state_construct
        c:386-417), double-checked on the dirty counter."""
        if self.incremental or not self.reconstruct:
            return
        with self._lock:
            if not self.reconstruct:
                return
            queue = [ROOT]
            head = 0
            while head < len(queue):
                r = queue[head]
                head += 1
                for a, s in self.transitions[r].items():
                    queue.append(s)
                    # Re-entrant reset (ref c:381).
                    self.nb_outputs[s] = 1 if self.is_end[s] else 0
                    self._complete_fail_state(r, s, a)
            self.reconstruct = 0

    # -- matching (Algorithm 1) --------------------------------------------

    def _goto_existing(self, state: int, letter: int) -> int:
        # ref state_goto (c:167-192) with the root LOOP_0 simulation
        # (c:179-186): undefined transition from root loops to root.
        while True:
            nxt = self.transitions[state].get(letter)
            if nxt is not None:
                return nxt
            if state == ROOT:
                return ROOT
            state = self.fail[state]

    def match(self, state: int, letter: int) -> Tuple[int, int]:
        """One streaming match step (ref acm_match c:433-448).
        Returns (next_state, nb_outputs)."""
        self.ensure_fail_states()
        nxt = self._goto_existing(state, letter)
        return nxt, self.nb_outputs[nxt]

    def get_match_state(self, state: int, index: int) -> int:
        """index-th matching end-state along the fail chain; index 0 = the
        longest match (ref acm_get_match c:450-466)."""
        if index >= self.nb_outputs[state]:
            raise IndexError("match index out of bounds (ref c:456)")
        i = 0
        while True:
            while not self.is_end[state]:
                state = self.fail[state]
            if i == index:
                return state
            state = self.fail[state]
            i += 1

    def kw_rank_of(self, state: int) -> int:
        return self.kw_rank[state]

    def keyword_letters(self, state: int) -> List[int]:
        """Letter ids of the keyword ending at ``state``, reconstructed
        backwards via previous links (ref c:471-480)."""
        out: List[int] = []
        while self.prev_state[state] != NO_STATE:
            out.append(self.prev_letter[state])
            state = self.prev_state[state]
        out.reverse()
        return out

    def iter_keywords(self, sort_key=None) -> Iterator[Tuple[int, List[int]]]:
        """DFS over the trie, yielding (end_state, letter_ids) per keyword
        (ref acm_foreach_keyword c:490-531; order = comparator order,
        depth-first). ``sort_key`` maps a letter id to the user comparator key
        (vocab.sort_key); default is letter-id (= first-insertion) order."""
        letters: List[int] = []
        key = sort_key or (lambda a: a)

        def rec(s: int) -> Iterator[Tuple[int, List[int]]]:
            if self.is_end[s] and letters:
                yield s, list(letters)
            for a in sorted(self.transitions[s], key=key):
                letters.append(a)
                yield from rec(self.transitions[s][a])
                letters.pop()

        yield from rec(ROOT)

    # -- dense emission ----------------------------------------------------

    def emit_tables(self, vocab_size: Optional[int] = None) -> DenseTables:
        """Collapse goto+fail into a total dense transition table.

        delta[s, a] = goto(s, a) resolved through the fail chain — the whole
        runtime loop of the reference's state_goto (c:167-192) precomputed, so
        the device scan is a single gather per symbol. Children are filled in
        BFS order so a state's row starts as a copy of its fail state's final
        row (depth(f(s)) < depth(s) guarantees availability).
        """
        self.ensure_fail_states()
        with self._lock:
            S = self.n_states
            V = (vocab_size if vocab_size is not None else self.max_letter + 1)
            if V < self.max_letter + 1:
                raise ValueError("vocab_size smaller than largest letter id")
            delta = np.zeros((S, V), dtype=np.int32)
            fail = np.array(
                [f if f != NO_STATE else ROOT for f in self.fail],
                dtype=np.int32)

            # BFS over the trie.
            order = [ROOT]
            head = 0
            while head < len(order):
                r = order[head]
                head += 1
                order.extend(self.transitions[r].values())
            for s in order:
                if s != ROOT:
                    delta[s] = delta[fail[s]]
                row = delta[s]
                for a, t in self.transitions[s].items():
                    row[a] = t
            # delta[:, OOV] is already 0 == root: OOV behaves like an
            # undefined transition from the root (README.md:347, mod [3]).

            # Emit CSR: per-state end-states along the fail chain, self
            # (longest) first — preserves acm_get_match index order (c:459-466).
            emits: List[List[int]] = [[] for _ in range(S)]
            for s in order:
                own = [s] if self.is_end[s] else []
                emits[s] = own + (emits[fail[s]] if s != ROOT else [])
            emit_start = np.zeros(S + 1, dtype=np.int32)
            for s in range(S):
                emit_start[s + 1] = emit_start[s] + len(emits[s])
            emit_state = np.fromiter(
                (e for lst in emits for e in lst), dtype=np.int32,
                count=int(emit_start[-1]))

            nb_outputs = np.array(self.nb_outputs, dtype=np.int32)
            # Invariant: |output(s)| equals the emit-list length.
            assert np.array_equal(nb_outputs, np.diff(emit_start)), \
                "output counts diverge from fail-chain emit lists"

            return DenseTables(
                delta=delta,
                nb_outputs=nb_outputs,
                fail=fail,
                depth=np.array(self.depth, dtype=np.int32),
                is_end=np.array(self.is_end, dtype=bool),
                kw_rank=np.array(self.kw_rank, dtype=np.int32),
                prev_state=np.array(
                    [p if p != NO_STATE else NO_STATE for p in self.prev_state],
                    dtype=np.int32),
                prev_letter=np.array(self.prev_letter, dtype=np.int32),
                emit_start=emit_start,
                emit_state=emit_state,
                version=self.version,
                n_keywords=self.nb_sequences,
            )
