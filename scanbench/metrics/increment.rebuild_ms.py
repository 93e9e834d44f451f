"""increment.rebuild_ms: the host work of a snapshot rebuild (the self
time of the program's ``ac.snapshot.build`` spans, their uploads left
out) per traced refresh(), in ms."""

from scanbench.harness import program


def read(run):
    return program.span_self_ms(run, "ac.snapshot.build", root="ac.refresh")
