"""retrieve.device_idle: the share of the traced part of the window with no
kernel, copy or memset on the device."""

from scanbench.harness import readers


def read(run):
    return readers.device_idle(run)
