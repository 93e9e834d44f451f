"""Functional API shim — 1:1 with the reference's 12 exported symbols.

The port's copy of ``aho_corasick_1975_tpu/api.py``, unchanged.

Thin wrappers over ``models.machine.Machine`` mirroring aho_corasick.h:45-98
name-for-name, so code written against the reference's C API translates
mechanically. The object API (Machine/Cursor/DenseScanner) is the idiomatic
surface; this module exists for parity and for the conformance tests that
replay the reference examples literally.

Reference symbol map (aho_corasick.h line refs):
  acm_create (h:45), acm_initiate (h:48), acm_insert_letter_of_keyword
  (h:53), acm_insert_end_of_keyword (h:65), acm_match (h:70),
  acm_matcher_init (h:74), acm_get_match (h:81), acm_matcher_release (h:84),
  acm_nb_keywords (h:87), acm_foreach_keyword (h:90), acm_release (h:93),
  acm_print (h:97), ACM_CMP_DEFAULT (h:35), ACM_INCREMENTAL_STRING_MATCHING
  (h:98).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, IO, Optional

from .models.machine import Cursor, Machine, Match

# The reference default comparator is memcmp over the raw sign (c:134-138);
# the dense-id equivalent is the identity key.
ACM_CMP_DEFAULT = None  # i.e. Vocab identity_key

# The reference fixes the algorithm variant at compile time via -DNMEYER_85
# and reports it through this constant (h:98, c:596-600). Here the mode is a
# per-machine constructor flag, so the h:98 semantics live in
# acm_incremental_string_matching(machine) below; this module constant only
# reports the *default-build* mode (Meyer 1985 incremental, like the
# reference's default build).
ACM_INCREMENTAL_STRING_MATCHING = 1


def acm_incremental_string_matching(machine: Machine) -> int:
    """Reference h:98 semantics, per machine: 1 when this machine maintains
    fail links incrementally on insertion (Meyer 1985), 0 when it rebuilds
    lazily before the next match (AC75, the reference's -DNMEYER_85)."""
    return 1 if machine.incremental else 0

MatchHolder = Match  # type alias for reference-named code


def acm_create(key_fn: Optional[Callable[[Any], Any]] = ACM_CMP_DEFAULT,
               incremental: bool = True, backend: str = "auto",
               cmp_fn: Optional[Callable[[Any, Any], int]] = None) -> Machine:
    """``cmp_fn`` is the reference's ``cmp``/``cmp_arg`` contract verbatim
    (h:33-38): a total order over opaque keys, no hashability required
    (bind cmp_arg with functools.partial)."""
    return Machine(key_fn=key_fn, incremental=incremental, backend=backend,
                   cmp_fn=cmp_fn)


def acm_release(machine: Machine) -> None:
    """No-op: lifetime is garbage-collected (the reference frees the trie,
    letters and values here, c:153-159)."""


def acm_initiate(machine: Machine) -> Cursor:
    return machine.initiate()


def acm_insert_letter_of_keyword(cursor: Cursor, sign: Any) -> None:
    cursor.machine.insert_letter_of_keyword(cursor, sign)


def acm_insert_end_of_keyword(cursor: Cursor, value: Any = None) -> Any:
    return cursor.machine.insert_end_of_keyword(cursor, value)


def acm_match(cursor: Cursor, sign: Any) -> int:
    return cursor.machine.match(cursor, sign)


def acm_matcher_init() -> list:
    """Returns a mutable one-slot holder for acm_get_match to fill, emulating
    the reference's reusable MatchHolder (h:72-74)."""
    return [None]


def acm_get_match(cursor: Cursor, index: int,
                  matcher: Optional[list] = None) -> Match:
    m = cursor.machine.get_match(cursor, index)
    if matcher is not None:
        matcher[0] = m
    return m


def acm_matcher_release(matcher: list) -> None:
    matcher[0] = None


def acm_nb_keywords(machine: Machine) -> int:
    return machine.nb_keywords()


def acm_foreach_keyword(machine: Machine,
                        op: Callable[[Match], None]) -> None:
    machine.foreach_keyword(op)


def acm_print(machine: Machine, stream: Optional[IO[str]] = None,
              printer: Optional[Callable[[Any], str]] = None) -> None:
    machine.print(stream or sys.stdout, printer)
