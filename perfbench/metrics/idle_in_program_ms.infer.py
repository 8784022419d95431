"""Device idle time a request of the traced window while some program span
(`data.to_device`, `infer.forward`) is open on the host (`spans.py`): the
idle gaps of the window, split over the innermost span open across each
part, summed over the span names and divided by the traced requests; the
parts that no span covers (the answer's copy to the host) are left out."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    return p.idle_in_program_ms if p is not None and p.unit == "infer.forward" else None
