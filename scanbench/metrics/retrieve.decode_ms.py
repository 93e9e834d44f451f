"""retrieve.decode_ms: the host decode of the hits into events and the
lazy columns read out (the program's ``ac.decode`` spans) per traced
find_matches() call, in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.decode")
