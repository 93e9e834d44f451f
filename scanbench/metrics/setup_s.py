"""setup_s: process start to the first timed call, in s: imports, the
inputs, the automaton, the scanner and the warm-up (and, in the first run in
a checkout, the kernels' nvcc build)."""


def read(run):
    return run.setup_s
