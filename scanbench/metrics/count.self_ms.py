"""count.self_ms: the self time of the program's ``ac.count`` span (its
duration less its children's: fill, wait, launches, uploads) per traced
count() call, in ms: dispatch, and the wait for the device at the end."""

from scanbench.harness import program


def read(run):
    return program.span_self_ms(run, "ac.count")
