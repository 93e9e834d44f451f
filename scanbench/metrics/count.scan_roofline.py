"""count.scan_roofline: the traced count() calls' least time (the
bytes of roofline.scan_bytes at 3.35 TB/s) over the summed time of every
kernel they launched, in %."""

from scanbench.harness import readers


def read(run):
    return readers.scan_roofline(run, "count")
