"""increment_ms: the window's seconds over the increments it completed
(whole cycles: insert, scanner live, count), in ms."""

from scanbench.harness import readers


def read(run):
    if run.traffic["loop"] != "cycles":
        return None
    return readers.per_unit_ms(run)
