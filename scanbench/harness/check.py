"""The comparison that decides ``correct``: every answer the window
produced against the plain reference (``scanbench/reference.py``), which
is given the same keywords and texts as the program and nothing the
program made; the mix's loop says what the reference answers to each text
(``loops.Loop.want``).

Two numbers are compared, each with its limit: ``wrong_answers``, the
answers that differ from the reference's (a count, or the whole list of
(end, keyword id) occurrences), and ``failed_calls``, the calls that raised
and so never answered. Both are exact: the limit is 0."""

from __future__ import annotations

LIMITS = {"wrong_answers": 0, "failed_calls": 0}


def compare(calls, want: dict, same) -> dict:
    """{name: {"value", "limit"}} over every call of the window; ``same``
    is the operation's agreement of an answer with the reference's."""
    failed = sum(c.error is not None for c in calls)
    wrong = sum(c.error is None and not same(c.answer, want[c.doc])
                for c in calls)
    return {"wrong_answers": {"value": wrong,
                              "limit": LIMITS["wrong_answers"]},
            "failed_calls": {"value": failed,
                             "limit": LIMITS["failed_calls"]}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
