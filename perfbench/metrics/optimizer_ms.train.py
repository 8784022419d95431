"""Device time a step of the optimizer's update: the device records of the
traced window launched while the program's `train.optimizer` span (around
`optimizer.step()`) was the innermost span open on the host (`spans.py`),
divided by the traced steps; the span's counterpart of `adamw_ms.train`."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    if p is None or p.unit != "train.step":
        return None
    return p.device_ms.get("train.optimizer")
