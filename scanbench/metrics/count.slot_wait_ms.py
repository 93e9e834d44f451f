"""count.slot_wait_ms: the host's wait for a staging slot whose last
copy is in flight (the program's ``ac.stage.wait`` spans) per traced
count() call, in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.stage.wait")
