"""increment.inplace_share: the share of refresh() calls that returned
True (in place, not a rebuild)."""

from scanbench.harness import readers


def read(run):
    return readers.inplace_share(run)
