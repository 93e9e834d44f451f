"""retrieve.host_ms: the traced find_matches() calls' mean wall time
(the read-out included) less their mean device busy time, in ms."""

from scanbench.harness import readers


def read(run):
    return readers.host_ms(run, "find_matches")
