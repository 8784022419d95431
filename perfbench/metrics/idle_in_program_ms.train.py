"""Device idle time a step of the traced window while some program span
is open on the host (`spans.py`): the idle gaps of the window, split over
the innermost span open across each part, summed over every span name and
divided by the traced steps; the parts that no span covers are left out."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    return p.idle_in_program_ms if p is not None and p.unit == "train.step" else None
