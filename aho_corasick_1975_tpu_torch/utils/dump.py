"""ASCII automaton dump — format parity with the reference's acm_print.

The port's copy of ``aho_corasick_1975_tpu/utils/dump.py``, unchanged.

Reproduces the rendering of aho_corasick.c:533-594: a depth-first trie walk
printing ``(id)---letter-->(id)`` edges, ``[+n]`` output counts on
end-of-keyword states, and ``(v id)`` fail links that don't point at the
root, with the same column-cursor layout (new branch rows begin with ``L``).
State ids match the reference's creation-order UIDs, so dumps of identically
built machines are directly comparable.

Also validates, as the reference does by assertion while printing
(c:562, c:578-579), that previous-links and fail-links are self-consistent.
"""

from __future__ import annotations

from typing import IO, Any, Callable, Optional

from ..core.builder import NO_STATE, ROOT


def print_machine(machine, stream: IO[str],
                  printer: Optional[Callable[[Any], str]] = None) -> None:
    b = machine._b
    vocab = machine.vocab
    b.ensure_fail_states()  # AC75 parity: rebuild before printing (c:586-588)
    p = printer or (lambda sign: str(sign))
    cursor = 0

    def write(s: str) -> int:
        stream.write(s)
        return len(s)

    def state_print(state: int, indent: int) -> None:
        nonlocal cursor
        # Invariant checks (ref c:578-579).
        assert not b.is_end[state] or b.nb_outputs[state], \
            "Keyword without defined output."
        # (the native backend exports the root's undefined fail as ROOT)
        assert state == ROOT or b.fail[state] != NO_STATE, \
            "Incorrect fail state."
        for a in sorted(b.transitions[state], key=vocab.sort_key):
            transition_print(state, a, b.transitions[state][a], indent)

    def transition_print(state: int, letter: int, child: int,
                         indent: int) -> None:
        nonlocal cursor
        if indent < cursor:
            cursor = 0
            write("\n")
            if indent:
                for _ in range(indent - 1):
                    cursor += write(" ")
                cursor += write("L")
        elif indent > cursor:
            for _ in range(indent - cursor):
                cursor += write(" ")
        if state == ROOT:
            cursor += write(f"({state:03d})")
        cursor += write("---")
        # previous-link consistency (ref c:562)
        assert b.prev_state[child] == state and b.prev_letter[child] == letter, \
            "Incorrect previous state."
        cursor += write(p(vocab.sign(letter)))
        cursor += write("-->")
        cursor += write(f"({child:03d})")
        if b.is_end[child]:
            cursor += write(f"[+{b.nb_outputs[child]}]")
        if b.fail[child] != ROOT:
            cursor += write(f"(v {b.fail[child]:03d})")
        state_print(child, cursor)

    write("\n")
    state_print(ROOT, 0)
    write("\n")
