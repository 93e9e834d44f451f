"""ByteMachine: fixed 256-symbol byte alphabet with vectorized encoding.

The port's copy of ``aho_corasick_1975_tpu/models/bytes_machine.py``,
unchanged.

The generic Machine resolves signs through a Python-dict vocabulary — exact
but O(T) Python work per scan. For byte streams (the reference's
``ACM_CMP_DEFAULT`` + sizeof(char) configuration, examples/test.c:4) the
alphabet is fixed, so encoding collapses to one numpy table lookup over the
whole buffer, and the dense tables use a constant V=257 (256 byte values
after the OOV slot; every byte is in-vocabulary).

This is also the scalable answer for *huge* alphabets (BASELINE config 4,
50k-multilingual-keyword Unicode): encode text as UTF-8 and match bytes —
state count grows modestly while the table width stays 257, where a
codepoint-vocab dense table would be S x 50k. See UnicodeMachine for the
codepoint-exact variant on moderate vocabularies.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .machine import Machine


class _ByteVocab:
    """Identity byte->id map: id = byte + 1 (0 stays OOV; no byte is OOV,
    but id 0 is kept so tables share the generic layout)."""

    key_fn = staticmethod(lambda b: b)
    size = 257
    _version = 0          # fixed alphabet: LUTs never invalidate
    str_encoding = "utf-8"  # str scans are UTF-8 byte streams

    def byte_lut(self) -> np.ndarray:
        """byte -> id LUT for the device-side encode (id = byte + 1)."""
        return np.arange(1, 257, dtype=np.int32)

    def codepoint_lut(self, eager_bound: int = 1024):
        return None  # str routes through UTF-8 bytes, not codepoints

    def register(self, sign: int) -> int:
        return int(sign) + 1

    def lookup(self, sign: int) -> int:
        return int(sign) + 1

    def lookup_many(self, signs) -> np.ndarray:
        if isinstance(signs, str):
            signs = signs.encode("utf-8")
        arr = np.frombuffer(signs, np.uint8) if isinstance(signs, (bytes, bytearray)) \
            else np.asarray(signs, np.uint8)
        return arr.astype(np.int32) + 1

    def sign(self, letter_id: int) -> int:
        return letter_id - 1

    def signs(self, letter_ids):
        return [i - 1 for i in letter_ids]

    def sort_key(self, letter_id: int) -> int:
        return letter_id


class ByteMachine(Machine):
    """Multi-pattern matcher over bytes (keywords and corpora are
    bytes/bytearray/uint8 arrays)."""

    def __init__(self, incremental: bool = True, backend: str = "auto"):
        super().__init__(key_fn=None, incremental=incremental,
                         backend=backend)
        self.vocab = _ByteVocab()

    def insert_keyword(self, data: Union[bytes, bytearray, np.ndarray],
                       value=None):
        if isinstance(data, str):
            data = data.encode("utf-8")
        arr = np.frombuffer(bytes(data), np.uint8)
        # delegate: Machine.insert_keyword owns the bulk path and the
        # duplicate-value protocol; _ByteVocab.register is byte -> byte+1
        return super().insert_keyword(arr.tolist(), value)

    def match_bytes(self, match) -> bytes:
        """Render a Match's letters back into bytes."""
        return bytes(match.letters)


def _casefold_key(ch: str) -> str:
    """Module-level (picklable) casefold key: UnicodeMachine(casefold=True)
    checkpoints round-trip without re-supplying key_fn at load."""
    return ch.casefold()


class UnicodeMachine(Machine):
    """Codepoint-alphabet matcher with optional case folding — the
    wide-character configuration of the reference's generic test
    (wchar_t + alphacmp, examples/aho_corasick_generic_test.c:48-54,176).

    Suitable while the *distinct codepoints appearing in keywords* stay
    moderate (the dense table is S x vocab); for open-ended multilingual
    dictionaries prefer ByteMachine over UTF-8.
    """

    def __init__(self, casefold: bool = False, incremental: bool = True,
                 backend: str = "auto"):
        key = _casefold_key if casefold else None
        super().__init__(key_fn=key, incremental=incremental, backend=backend)
