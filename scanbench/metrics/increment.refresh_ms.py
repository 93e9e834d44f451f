"""increment.refresh_ms: the mean span around DenseScanner.refresh(), in
ms."""

from scanbench.harness import readers


def read(run):
    return readers.span_mean_ms(run, "refresh")
