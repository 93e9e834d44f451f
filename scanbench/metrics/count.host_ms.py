"""count.host_ms: the traced count() calls' mean wall time less their
mean device busy time, in ms."""

from scanbench.harness import readers


def read(run):
    return readers.host_ms(run, "count")
