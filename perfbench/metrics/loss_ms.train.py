"""Device time a step of the loss terms: the device records of the traced
window launched while the program's `train.loss` span (the RoiMSE, then
the batch-coupled RnC or tCDS term) was the innermost span open on the
host (`spans.py`), divided by the traced steps."""

from perfbench.spans import phases


def read(run):
    p = phases(run)
    if p is None or p.unit != "train.step":
        return None
    return p.device_ms.get("train.loss")
