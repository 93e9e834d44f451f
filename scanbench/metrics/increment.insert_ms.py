"""increment.insert_ms: the mean span around Machine.insert_keywords of
one increment, in ms."""

from scanbench.harness import readers


def read(run):
    return readers.span_mean_ms(run, "insert_keywords")
