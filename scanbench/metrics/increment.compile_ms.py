"""increment.compile_ms: the machine's emit of its dense tables (the
program's ``ac.compile`` spans) per traced refresh(), in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.compile", root="ac.refresh")
