"""Sign→dense-id vocabulary map — the genericity layer.

The port's copy of ``aho_corasick_1975_tpu/utils/vocab.py``, unchanged.

The reference keeps letters fully generic (``void*`` signs + a user comparator,
aho_corasick.h:33-45, cmp_default c:134-138) and pays an ordered-map lookup per
symbol at scan time. The TPU-native design resolves genericity *once*, at
registration time: every distinct sign (equivalence class under the user key
function) gets a dense ``int32`` id, and the scan operates on ids only.

* ``key_fn`` plays the role of the reference's ``cmp``/``cmp_arg`` pair: two
  signs are the same letter iff their keys are equal (e.g. case-insensitive
  matching via ``key_fn=str.lower`` — the reference's ``alphacmp``,
  examples/aho_corasick_generic_test.c:48-54).
* Keys must be orderable; enumeration/print order is key order, mirroring the
  reference's comparator-ordered map traversal (c:518, c:580).
* Id 0 is reserved for OOV. A sign never seen in any keyword maps to 0, which
  the dense tables route to the root — exactly the behaviour of an undefined
  transition from state 0 (reference modification [3], README.md:347).
* The *first* sign observed for a key is kept as the representative, matching
  the reference's edge-letter adoption rule (duplicate letters are destroyed,
  c:305-307; the edge keeps the first-inserted letter object).
"""

from __future__ import annotations

import bisect
from functools import cmp_to_key
from typing import Any, Callable, Dict, List, Optional

import numpy as np

OOV = 0

# Unicode codepoint space upper bound (LUT hard cap).
_MAX_CP = 0x110000


def identity_key(sign: Any) -> Any:
    """Default key: the sign itself (hashable signs, e.g. chars/ints/bytes)."""
    return sign


class Vocab:
    """``key_fn`` covers alphabets whose keys are hashable (the fast dict
    paths). ``cmp_fn`` covers the reference's full genericity contract —
    a total order over opaque signs with NO hashability requirement
    (aho_corasick.h:33-38: only ``cmp``/``cmp_arg`` exist there). With
    ``cmp_fn`` the id map is a sorted list searched by binary comparison
    (O(log n) per sign, list insertion on registration); two signs are the
    same letter iff cmp(key(a), key(b)) == 0. The vectorized encode fast
    paths remain exact in cmp mode (their per-codepoint/byte LUT cache
    classifies through the comparator)."""

    def __init__(self, key_fn: Optional[Callable[[Any], Any]] = None,
                 cmp_fn: Optional[Callable[[Any, Any], int]] = None):
        self.key_fn = key_fn or identity_key
        self.cmp_fn = cmp_fn
        self._cmp_key = cmp_to_key(cmp_fn) if cmp_fn is not None else None
        self._sorted_keys: List[Any] = []   # cmp mode: wrapped keys, sorted
        self._sorted_ids: List[int] = []
        self._ids: Dict[Any, int] = {}
        self._signs: List[Any] = [None]  # index 0 = OOV placeholder
        self._keys: List[Any] = [None]
        # Encode fast-path caches (see lookup_many). Invalidated whenever a
        # new id is registered; entries are recomputed lazily, per observed
        # codepoint/byte, by evaluating key_fn exactly as lookup() would —
        # so the vectorized paths are exact for ANY pure key_fn.
        self._version = 0
        self._cp_lut: Optional[np.ndarray] = None   # codepoint -> id; -1 = unclassified
        self._cp_version = -1
        self._byte_lut: Optional[np.ndarray] = None  # int sign 0..255 -> id
        self._byte_version = -1

    def __len__(self) -> int:
        return len(self._signs)  # includes the OOV slot

    @property
    def size(self) -> int:
        return len(self._signs)

    def _id_of_key(self, k: Any) -> int:
        """Key -> id (OOV when unseen); comparator search in cmp mode."""
        if self._cmp_key is None:
            return self._ids.get(k, OOV)
        w = self._cmp_key(k)
        i = bisect.bisect_left(self._sorted_keys, w)
        if i < len(self._sorted_keys) and self._sorted_keys[i] == w:
            return self._sorted_ids[i]
        return OOV

    def register(self, sign: Any) -> int:
        """Intern a sign (keyword insertion path). Allocates a fresh id for an
        unseen key; keeps the first-seen sign as representative."""
        k = self.key_fn(sign)
        if self._cmp_key is None:
            i = self._ids.get(k)
            if i is None:
                i = len(self._signs)
                self._ids[k] = i
                self._signs.append(sign)
                self._keys.append(k)
                self._version += 1
            return i
        w = self._cmp_key(k)
        pos = bisect.bisect_left(self._sorted_keys, w)
        if pos < len(self._sorted_keys) and self._sorted_keys[pos] == w:
            return self._sorted_ids[pos]
        i = len(self._signs)
        self._sorted_keys.insert(pos, w)
        self._sorted_ids.insert(pos, i)
        self._signs.append(sign)
        self._keys.append(k)
        self._version += 1
        return i

    def lookup(self, sign: Any) -> int:
        """Map a scan-time sign to its id; unknown signs are OOV."""
        return self._id_of_key(self.key_fn(sign))

    def lookup_many(self, signs):
        """Map a stream of signs to ids (unknown -> OOV), vectorized.

        Fast paths (return int32 ndarrays):
          * ``str`` — one LUT gather per codepoint; the LUT is grown lazily
            per observed codepoint by evaluating ``key_fn(chr(cp))`` exactly
            as ``lookup`` would, so any pure key function (casefolding,
            accent folding, ...) stays exact;
          * ``bytes``/``bytearray`` — 256-entry LUT over int signs 0..255;
          * integer ndarrays/lists — np.unique + per-unique dict lookup;
          * lists of 1-char strings — joined into the str path.
        Everything else falls back to the per-sign loop (returns a list).
        This is the scan-time genericity resolution the reference pays an
        ordered-map lookup per symbol for (aho_corasick.c:175).
        """
        if isinstance(signs, str):
            return self._encode_str(signs)
        if isinstance(signs, (bytes, bytearray)):
            return self._encode_byte_ints(np.frombuffer(bytes(signs),
                                                        np.uint8))
        if isinstance(signs, np.ndarray) and signs.dtype.kind in "iu":
            if signs.dtype == np.uint8:
                # same domain as the bytes path: one 256-entry LUT gather
                # (the generic int path below np.unique-SORTS the whole
                # array — minutes at GB scale)
                return self._encode_byte_ints(signs)
            return self._encode_ints(signs)
        if isinstance(signs, (list, tuple)) and signs:
            first = signs[0]
            if isinstance(first, str):
                try:
                    joined = "".join(signs)
                except TypeError:
                    joined = None
                if joined is not None and len(joined) == len(signs):
                    return self._encode_str(joined)
            elif isinstance(first, (int, np.integer)) and not isinstance(
                    first, bool):
                try:
                    arr = np.asarray(signs, dtype=np.int64)
                except (TypeError, ValueError, OverflowError):
                    arr = None
                if arr is not None:
                    return self._encode_ints(arr)
        key = self.key_fn
        idk = self._id_of_key
        return [idk(key(s)) for s in signs]

    # -- vectorized encode internals ----------------------------------------

    def _encode_str(self, s: str) -> np.ndarray:
        # Codepoints without copy: utf-32-le IS the codepoint array. The
        # int32 view is safe (max codepoint 0x10FFFF < 2^31) and indexes
        # marginally faster than uint32. Steady state is exactly two passes:
        # one LUT gather + one min-reduction (-1 sentinel = unclassified
        # codepoint) — minimal memory traffic, which dominates on hosts with
        # slow first-touch page faults.
        cps = np.frombuffer(s.encode("utf-32-le"),
                            dtype=np.uint32).view(np.int32)
        if cps.size == 0:
            return np.zeros(0, np.int32)
        if self._cp_version != self._version:
            # Dictionary grew: forget cached classifications (ids stay
            # append-only, but a codepoint previously OOV may now be known).
            self._cp_lut = None
            self._cp_version = self._version
        lut = self._cp_lut
        hi = int(cps.max()) + 1
        if lut is None or lut.shape[0] < hi:
            lut = np.full(min(max(hi, 256), _MAX_CP), -1, np.int32)
            if self._cp_lut is not None:
                lut[:self._cp_lut.shape[0]] = self._cp_lut
            self._cp_lut = lut
        out = lut[cps]
        if int(out.min()) < 0:
            key, idk = self.key_fn, self._id_of_key
            for cp in np.unique(cps[out < 0]).tolist():
                lut[cp] = idk(key(chr(cp)))
            out = lut[cps]
        return out

    def _encode_byte_ints(self, arr: np.ndarray) -> np.ndarray:
        return self.byte_lut()[arr]

    def byte_lut(self) -> np.ndarray:
        """The 256-entry byte->id LUT (int signs 0..255 through key_fn),
        rebuilt lazily per vocabulary version. Exact for any byte input —
        this is also the table the device-side encode gathers through
        (models/scanner.py raw path)."""
        if self._byte_version != self._version or self._byte_lut is None:
            key, idk = self.key_fn, self._id_of_key
            self._byte_lut = np.asarray(
                [idk(key(b)) for b in range(256)], np.int32)
            self._byte_version = self._version
        return self._byte_lut

    def codepoint_lut(self, eager_bound: int = 1024):
        """Codepoint->id LUT for DEVICE-side str encode, or None.

        Returns (lut int32 [bound + 1], needs_max_check):

        * identity key_fn: the LUT is built from the registered single-char
          keys; ``bound`` = largest registered codepoint + 1 and the final
          entry is the OOV sentinel — any scan codepoint >= bound is OOV by
          construction (identity: unregistered <=> OOV), and XLA's gather
          clamps out-of-range indices onto that sentinel, so the device
          encode is EXACT with no host pass (needs_max_check=False).
        * general key_fn: the LUT is built eagerly by evaluating
          key_fn(chr(cp)) for cp < ``eager_bound`` — exact only for inputs
          whose codepoints all fall below the bound, so the caller must
          verify max(cps) < bound per call (needs_max_check=True) and fall
          back to the lazy host path (lookup_many) otherwise.

        The host path remains exact for everything; this LUT exists so the
        scan jit can fold the encode gather into the device graph
        (reference anchor: the zero-encode streaming loop, aho_corasick.c
        c:433-448 — its equivalent here must include getting symbols onto
        the chip)."""
        identity = self.key_fn is identity_key and self.cmp_fn is None
        if identity:
            cps = [ord(k) for k in self._ids
                   if isinstance(k, str) and len(k) == 1]
            bound = (max(cps) + 1) if cps else 1
            lut = np.zeros(bound + 1, np.int32)
            for k, i in self._ids.items():
                if isinstance(k, str) and len(k) == 1:
                    lut[ord(k)] = i
            return lut, False
        bound = min(max(256, int(eager_bound)), _MAX_CP)
        key, idk = self.key_fn, self._id_of_key
        lut = np.zeros(bound + 1, np.int32)
        for cp in range(bound):
            lut[cp] = idk(key(chr(cp)))
        return lut, True

    def _encode_ints(self, arr: np.ndarray) -> np.ndarray:
        if arr.size == 0:
            return np.zeros(0, np.int32)
        uniq, inv = np.unique(arr, return_inverse=True)
        key, idk = self.key_fn, self._id_of_key
        mapped = np.asarray([idk(key(int(v))) for v in uniq.tolist()],
                            np.int32)
        return mapped[inv.reshape(arr.shape)].astype(np.int32, copy=False)

    def sign(self, letter_id: int) -> Any:
        """Representative sign for a letter id (keyword reconstruction)."""
        return self._signs[letter_id]

    def signs(self, letter_ids) -> List[Any]:
        return [self._signs[i] for i in letter_ids]

    def sort_key(self, letter_id: int) -> Any:
        """Key used for comparator-order traversal parity (wrapped in the
        comparator's ordering object in cmp mode, so ``sorted`` orders
        enumeration exactly like the reference's comparator-ordered map
        traversal, c:518, c:580)."""
        k = self._keys[letter_id]
        return self._cmp_key(k) if self._cmp_key is not None else k
