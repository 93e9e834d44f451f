"""retrieve.refine_ms: the refinement of the live grams into hits (the
program's ``ac.refine`` spans) per traced find_matches() call, in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.refine")
