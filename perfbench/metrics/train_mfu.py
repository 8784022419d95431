"""The whole step's share of the chip's peak: the reference's operations
per unit (`reference/work.py`) times the units of the run's untraced
window, over that window's time on the host clock at the peak rate of the
compute dtype (`peaks.json`)."""

from perfbench.readers import mfu


def read(run):
    return mfu(run)
