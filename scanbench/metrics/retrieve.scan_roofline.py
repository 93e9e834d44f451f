"""retrieve.scan_roofline: the traced find_matches() calls' least scan time
(the bytes of roofline.scan_bytes over the reference's automaton at 3.35
TB/s) over the summed time of every kernel they launched, in %: the same
work whatever kernel does the walk."""

from scanbench.harness import readers


def read(run):
    return readers.scan_roofline(run, "find_matches")
