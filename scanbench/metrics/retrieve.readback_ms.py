"""retrieve.readback_ms: the read-back of the hits' positions and states
to the host (the program's ``ac.readback`` spans) per traced
find_matches() call, in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.readback")
