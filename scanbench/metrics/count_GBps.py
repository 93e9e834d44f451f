"""count_GBps: every document byte passed to count() in the window over
the window's seconds (closed loop, one client), in GB/s."""

from scanbench.harness import readers


def read(run):
    return readers.gbps(run, "count")
