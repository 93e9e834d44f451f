"""retrieve_GBps: every document byte passed to find_matches() in the
window over the window's seconds, each MatchSet's ends and keyword ids read
out, in GB/s."""

from scanbench.harness import readers


def read(run):
    return readers.gbps(run, "find_matches")
