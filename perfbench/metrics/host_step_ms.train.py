"""Host time of a train step with the profiler off: the mean duration of
the program's `train.step` span over the units of the run's unprofiled
window (`spans.py`), which opens at the step's first line and closes when
`optimizer.step()` returns, its launches queued."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    return p.unit_host_ms if p is not None and p.unit == "train.step" else None
