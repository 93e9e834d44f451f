"""retrieve.states_ms: K2's walk of the 1-char tables and the read-back of
its per-symbol states to the host (the program's ``ac.states`` spans) per
traced find_matches() call, in ms. A retrieval through a k-gram table, or
a program without the span, has none: the reader gives None."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.states")
