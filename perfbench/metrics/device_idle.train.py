"""The share of the traced window in which the device ran no kernel,
memcpy or memset: 1 - the union of their intervals over the window."""

from perfbench.readers import device_idle


def read(run):
    return device_idle(run)
