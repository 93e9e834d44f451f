"""increment.diff_ms: the snapshot's row diff and k-gram delta (the
program's ``ac.refresh.diff`` spans) per traced refresh(), in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.refresh.diff", root="ac.refresh")
