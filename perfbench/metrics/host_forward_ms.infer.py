"""Host time of a synthesis forward with the profiler off: the mean
duration of the program's `infer.forward` span over the units of the run's
unprofiled window (`spans.py`), from the inputs' move to the device to the
forward's last launch queued."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    return p.unit_host_ms if p is not None and p.unit == "infer.forward" else None
