"""count.fill_ms: the staging ring's host fill (the program's
``ac.stage.fill`` spans) per traced count() call, in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.stage.fill")
