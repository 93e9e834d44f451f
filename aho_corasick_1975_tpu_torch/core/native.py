"""ctypes binding for the native C++ automaton core (native/acx.cpp).

The port's copy of ``aho_corasick_1975_tpu/core/native.py`` (and of its
``native/acx.cpp``), unchanged but for where the library is built.

Presents the exact backend interface of core.builder.Builder (insert_letter,
insert_end, match, get_match_state, keyword_letters, iter_keywords,
emit_tables, array properties), so models.machine.Machine can swap backends
transparently (backend="auto" prefers native, falls back to Python).

The shared library builds at first use with g++ into the port's build
directory (``ops/build.py:BUILD_DIR``), never next to its source: the
library's name carries a hash of the source and the command, and
processes that build at once share one build through ``ops/build.py``'s
file lock and atomic rename.
"""

from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .builder import NO_STATE, ROOT, DenseTables, round_cap

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "acx.cpp")
_build_lock = threading.Lock()
_lib = None
library_path: Optional[str] = None   # the loaded libacx, once built


def _build() -> str:
    """Build libacx (or find it built) under the port's build directory;
    return its path."""
    from ..ops.build import build_library

    def stages(out, paths):
        return [[["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                  "-o", out, *paths]]]
    return build_library("acx", [_SRC], stages)


def load_library():
    global _lib, library_path
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        so = _build()
        lib = ct.CDLL(so)
        library_path = so
        i32, i64, i8, u8 = ct.c_int32, ct.c_int64, ct.c_int8, ct.c_uint8
        p = ct.POINTER
        lib.acx_create.restype = ct.c_void_p
        lib.acx_create.argtypes = [ct.c_int]
        lib.acx_release.argtypes = [ct.c_void_p]
        lib.acx_insert_letter.restype = i32
        lib.acx_insert_letter.argtypes = [ct.c_void_p, i32, i32]
        lib.acx_insert_end.restype = i32
        lib.acx_insert_end.argtypes = [ct.c_void_p, i32]
        lib.acx_insert_keywords.argtypes = [
            ct.c_void_p, p(i32), p(i64), i64, p(i32), p(i8)]
        lib.acx_restore_machine.restype = i64
        lib.acx_restore_machine.argtypes = [ct.c_void_p, p(i32), p(i32),
                                            p(u8), p(i32), i64]
        lib.acx_match.restype = i64
        lib.acx_match.argtypes = [ct.c_void_p, i32, i32, p(i32)]
        lib.acx_match_bulk.restype = i64
        lib.acx_match_bulk.argtypes = [ct.c_void_p, p(i32), p(i32), i64]
        lib.acx_match_stream_threaded.restype = i64
        lib.acx_match_stream_threaded.argtypes = [
            ct.c_void_p, p(i32), p(i32), i64, i64]
        lib.acx_match_bulk_many.argtypes = [
            ct.c_void_p, p(i32), p(i64), i64, p(i64), p(i32)]
        lib.acx_get_match_state.restype = i32
        lib.acx_get_match_state.argtypes = [ct.c_void_p, i32, i64]
        for name in ("acx_n_states", "acx_nb_sequences", "acx_version",
                     "acx_reconstruct", "acx_n_edges"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = [ct.c_void_p]
        lib.acx_max_letter.restype = i32
        lib.acx_max_letter.argtypes = [ct.c_void_p]
        lib.acx_ensure_fail_states.argtypes = [ct.c_void_p]
        lib.acx_export_arrays.restype = i64
        lib.acx_export_arrays.argtypes = [ct.c_void_p, i64] + [p(i32)] * 3 + \
            [p(u8)] + [p(i32)] * 3
        lib.acx_debug_set_counts.argtypes = [ct.c_void_p, i32, i64, i64]
        lib.acx_emit_delta.argtypes = [ct.c_void_p, i32, p(i32)]
        lib.acx_emit_csr.argtypes = [ct.c_void_p, i64, p(i32), p(i32)]
        lib.acx_export_edges.argtypes = [ct.c_void_p, i64, p(i32), p(i32),
                                         p(i32)]
        lib.acx_set_version.argtypes = [ct.c_void_p, i64]
        lib.acx_keyword_letters.restype = i64
        lib.acx_keyword_letters.argtypes = [ct.c_void_p, i32, p(i32), i64]
        lib.acx_kw_rank.restype = i64
        lib.acx_kw_rank.argtypes = [ct.c_void_p, i32]
        lib.acx_max_letter_id.restype = i32
        lib.acx_max_letter_id.argtypes = []
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(ct.POINTER(typ))


class NativeBuilder:
    """Backend-compatible wrapper over the C++ core."""

    def __init__(self, incremental: bool = True):
        self._lib = load_library()
        self._max_letter_id = int(self._lib.acx_max_letter_id())
        self._h = ct.c_void_p(self._lib.acx_create(1 if incremental else 0))
        self.incremental = incremental
        self._snap_version = -1
        self._arrays = None   # (fail, prev_state, prev_letter, is_end,
        #                        nb_outputs, depth, kw_rank)
        self._children = None

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.acx_release(self._h)
                self._h = None
        except Exception:
            pass

    # -- core ops ----------------------------------------------------------

    @property
    def n_states(self) -> int:
        return int(self._lib.acx_n_states(self._h))

    @property
    def nb_sequences(self) -> int:
        return int(self._lib.acx_nb_sequences(self._h))

    @property
    def version(self) -> int:
        return int(self._lib.acx_version(self._h))

    @property
    def reconstruct(self) -> int:
        return int(self._lib.acx_reconstruct(self._h))

    @property
    def max_letter(self) -> int:
        return int(self._lib.acx_max_letter(self._h))

    def insert_letter(self, state: int, letter: int) -> int:
        if letter <= 0:
            raise ValueError("letter ids must be >= 1 (0 is reserved for OOV)")
        if letter > self._max_letter_id:
            raise ValueError(
                f"letter id {letter} exceeds the native core's limit "
                f"({self._max_letter_id}); use backend='python' or a "
                f"byte-level encoding (ByteMachine) for alphabets this wide")
        return int(self._lib.acx_insert_letter(self._h, state, letter))

    def insert_end(self, state: int) -> bool:
        if state == ROOT:
            raise ValueError("insert_letter must be called first (ref c:345)")
        return bool(self._lib.acx_insert_end(self._h, state))

    def insert_keywords_bulk(self, letters: np.ndarray,
                             offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Insert many keywords in one native call.
        letters: int32 concatenated ids; offsets: int64 [n+1]."""
        letters = np.ascontiguousarray(letters, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        if letters.size and int(letters.max()) > self._max_letter_id:
            raise ValueError(
                f"letter id {int(letters.max())} exceeds the native core's "
                f"limit ({self._max_letter_id}); use backend='python' or a "
                f"byte-level encoding (ByteMachine)")
        if letters.size and int(letters.min()) <= 0:
            raise ValueError("letter ids must be >= 1 (0 is reserved for OOV)")
        n = len(offsets) - 1
        ends = np.empty(n, np.int32)
        fresh = np.empty(n, np.int8)
        self._lib.acx_insert_keywords(
            self._h, _ptr(letters, ct.c_int32), _ptr(offsets, ct.c_int64),
            n, _ptr(ends, ct.c_int32), _ptr(fresh, ct.c_int8))
        return ends, fresh.astype(bool)

    def restore_machine(self, prev_state: np.ndarray,
                        prev_letter: np.ndarray, is_end: np.ndarray,
                        kw_rank: np.ndarray) -> None:
        """Checkpoint restore in ONE native call: recreate the whole trie
        from creation-order (parent, letter) backlinks — state s regains
        exactly id s — adopt end flags/ranks, and rebuild fail/IF/output
        in a single depth-order pass (utils/checkpoint.py replaces its
        one-FFI-call-per-state loop with this). The machine must be
        freshly constructed."""
        prev_state = np.ascontiguousarray(prev_state, np.int32)
        prev_letter = np.ascontiguousarray(prev_letter, np.int32)
        is_end = np.ascontiguousarray(is_end, np.uint8)
        kw_rank = np.ascontiguousarray(kw_rank, np.int32)
        if self.n_states != 1 or self.nb_sequences:
            raise ValueError("restore_machine needs a fresh machine")
        bad = int(self._lib.acx_restore_machine(
            self._h, _ptr(prev_state, ct.c_int32),
            _ptr(prev_letter, ct.c_int32), _ptr(is_end, ct.c_uint8),
            _ptr(kw_rank, ct.c_int32), len(prev_state)))
        if bad:
            raise ValueError(f"checkpoint replay diverged at state {bad}")
        self._snap_version = -1

    def match(self, state: int, letter: int) -> Tuple[int, int]:
        nxt = ct.c_int32()
        nb = self._lib.acx_match(self._h, state, letter, ct.byref(nxt))
        return int(nxt.value), int(nb)

    def match_bulk(self, state: int, letters: np.ndarray) -> Tuple[int, int]:
        letters = np.ascontiguousarray(letters, np.int32)
        s = ct.c_int32(state)
        total = self._lib.acx_match_bulk(self._h, ct.byref(s),
                                         _ptr(letters, ct.c_int32),
                                         len(letters))
        return int(s.value), int(total)

    def match_stream_threaded(self, state: int, letters: np.ndarray,
                              n_threads: int = 0) -> Tuple[int, int]:
        """Halo-blocked threaded count over one stream (exact; see
        acx_match_stream_threaded). n_threads<=0 = hardware default."""
        letters = np.ascontiguousarray(letters, np.int32)
        s = ct.c_int32(state)
        total = self._lib.acx_match_stream_threaded(
            self._h, ct.byref(s), _ptr(letters, ct.c_int32), len(letters),
            int(n_threads))
        return int(s.value), int(total)

    def match_bulk_many(self, letters: np.ndarray,
                        offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Threaded per-document batch count: letters concatenated,
        offsets[d]..offsets[d+1] delimit document d (each starts at the
        root). Returns (totals int64 [n], end_states int32 [n])."""
        letters = np.ascontiguousarray(letters, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        n = len(offsets) - 1
        totals = np.zeros(n, np.int64)
        ends = np.zeros(n, np.int32)
        self._lib.acx_match_bulk_many(
            self._h, _ptr(letters, ct.c_int32), _ptr(offsets, ct.c_int64),
            n, _ptr(totals, ct.c_int64), _ptr(ends, ct.c_int32))
        return totals, ends

    def get_match_state(self, state: int, index: int) -> int:
        r = int(self._lib.acx_get_match_state(self._h, state, index))
        if r == NO_STATE:
            raise IndexError("match index out of bounds (ref c:456)")
        return r

    def ensure_fail_states(self) -> None:
        self._lib.acx_ensure_fail_states(self._h)

    def set_version(self, v: int) -> None:
        self._lib.acx_set_version(self._h, int(v))
        self._snap_version = -1

    # -- array snapshots ----------------------------------------------------

    def _refresh(self):
        if self._snap_version == self.version and self._arrays is not None \
                and self._arrays[0].shape[0] == self.n_states:
            return
        self.ensure_fail_states()
        S = self.n_states
        fail = np.empty(S, np.int32)
        prev_state = np.empty(S, np.int32)
        prev_letter = np.empty(S, np.int32)
        is_end = np.empty(S, np.uint8)
        nb_outputs = np.empty(S, np.int32)
        depth = np.empty(S, np.int32)
        kw_rank = np.empty(S, np.int32)
        bad = int(self._lib.acx_export_arrays(
            self._h, S, _ptr(fail, ct.c_int32), _ptr(prev_state, ct.c_int32),
            _ptr(prev_letter, ct.c_int32), _ptr(is_end, ct.c_uint8),
            _ptr(nb_outputs, ct.c_int32), _ptr(depth, ct.c_int32),
            _ptr(kw_rank, ct.c_int32)))
        if bad:
            # Internal counters are int64; the export (and the device
            # tables) are int32. Refuse a silent wrap.
            raise OverflowError(
                f"state {bad - 1}: nb_outputs/kw_rank exceeds int32; the "
                "dense-table export cannot represent this dictionary")
        self._arrays = (fail, prev_state, prev_letter, is_end.astype(bool),
                        nb_outputs, depth, kw_rank)
        self._children = None
        self._snap_version = self.version

    @property
    def fail(self) -> np.ndarray:
        self._refresh()
        return self._arrays[0]

    @property
    def prev_state(self) -> np.ndarray:
        self._refresh()
        return self._arrays[1]

    @property
    def prev_letter(self) -> np.ndarray:
        self._refresh()
        return self._arrays[2]

    @property
    def is_end(self) -> np.ndarray:
        self._refresh()
        return self._arrays[3]

    @property
    def nb_outputs(self) -> np.ndarray:
        self._refresh()
        return self._arrays[4]

    @property
    def depth(self) -> np.ndarray:
        self._refresh()
        return self._arrays[5]

    @property
    def kw_rank(self) -> np.ndarray:
        self._refresh()
        return self._arrays[6]

    @property
    def transitions(self) -> List[dict]:
        """Per-state {letter: child} dicts, rebuilt on demand (introspection
        paths only — dump/print)."""
        self._refresh()
        if self._children is None:
            S = self.n_states
            E = int(self._lib.acx_n_edges(self._h))
            parents = np.empty(E, np.int32)
            letters = np.empty(E, np.int32)
            children = np.empty(E, np.int32)
            self._lib.acx_export_edges(
                self._h, E, _ptr(parents, ct.c_int32),
                _ptr(letters, ct.c_int32), _ptr(children, ct.c_int32))
            trans: List[dict] = [{} for _ in range(S)]
            for pa, le, ch in zip(parents.tolist(), letters.tolist(),
                                  children.tolist()):
                trans[pa][le] = ch
            self._children = trans
        return self._children

    # -- keyword reconstruction / enumeration -------------------------------

    def keyword_letters(self, state: int) -> List[int]:
        # native walk (no array snapshot): O(keyword length) even while the
        # machine mutates concurrently
        cap = 64
        while True:
            buf = np.empty(cap, np.int32)
            n = int(self._lib.acx_keyword_letters(self._h, state,
                                                  _ptr(buf, ct.c_int32), cap))
            if n <= cap:
                return buf[:n].tolist()
            cap = n

    def kw_rank_of(self, state: int) -> int:
        return int(self._lib.acx_kw_rank(self._h, state))

    def iter_keywords(self, sort_key=None) -> Iterator[Tuple[int, List[int]]]:
        trans = self.transitions
        is_end = self.is_end
        key = sort_key or (lambda a: a)
        letters: List[int] = []

        def rec(s: int):
            if is_end[s] and letters:
                yield s, list(letters)
            for a in sorted(trans[s], key=key):
                letters.append(a)
                yield from rec(trans[s][a])
                letters.pop()

        yield from rec(ROOT)

    # -- dense emission ------------------------------------------------------

    def emit_tables(self, vocab_size: Optional[int] = None) -> DenseTables:
        self.ensure_fail_states()
        self._refresh()
        (fail, prev_state, prev_letter, is_end, nb_outputs, depth,
         kw_rank) = self._arrays
        S = self.n_states
        V = vocab_size if vocab_size is not None else self.max_letter + 1
        if V < self.max_letter + 1:
            raise ValueError("vocab_size smaller than largest letter id")
        # Emit straight into a capacity-padded calloc'd buffer: the tail
        # rows cost nothing until touched (zero pages stay virtual), and a
        # DeviceSnapshot can adopt the buffer outright instead of paying a
        # second whole-table first-touch + copy (claim_cap_delta).
        cap = round_cap(S)
        cap_delta = np.zeros((cap, V), np.int32)
        self._lib.acx_emit_delta(self._h, V, _ptr(cap_delta, ct.c_int32))
        delta = cap_delta[:S]

        # Emit CSR from the fail chain, self (longest) first, natively in
        # depth order (was a per-state Python loop — seconds at 2.5M
        # states; the reference's runtime walk is acm_get_match c:457-466).
        emit_start = np.zeros(S + 1, np.int32)
        emit_start[1:] = np.cumsum(nb_outputs)
        emit_state = np.empty(int(emit_start[-1]), np.int32)
        # S bounds every CSR write to the snapshot geometry sized above
        # (emit_start was sized from the exported snapshot, so a builder
        # that advanced in between must not overrun emit_state).
        self._lib.acx_emit_csr(self._h, S, _ptr(emit_start, ct.c_int32),
                               _ptr(emit_state, ct.c_int32))

        # No .copy(): _refresh() allocates a fresh array set per version,
        # so snapshots never share storage across versions, and a
        # DenseTables is immutable by contract.
        return DenseTables(
            delta=delta, nb_outputs=nb_outputs, fail=fail,
            depth=depth, is_end=is_end, kw_rank=kw_rank,
            prev_state=prev_state, prev_letter=prev_letter,
            emit_start=emit_start, emit_state=emit_state,
            version=self.version, n_keywords=self.nb_sequences,
            cap_delta=cap_delta)

