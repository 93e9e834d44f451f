"""count.launches: the program's kernel launches (``ac.launch`` spans,
one per ``ops/build.py:launch``) per traced count() call."""

from scanbench.harness import program


def read(run):
    return program.span_count(run, "ac.launch")
