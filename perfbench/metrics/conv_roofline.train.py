"""The conv kernels' share of their roofline: the least time of every conv
of the window (forward, and in a train step both gradients), each the
larger of its operations over the peak rate and its bytes over the peak
bandwidth, over the device time of the kernels `kernel_classes.json`
classes as conv (hand-written and cuDNN alike)."""

from perfbench.readers import conv_roofline


def read(run):
    return conv_roofline(run)
