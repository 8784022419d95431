"""Device time per step of the optimizer's update: the work that starts
between the marker kernels the train generator puts before and after the
program's `optimizer.step()` (PyTorch's `Optimizer.step#AdamW.step`)."""


def read(run):
    seconds = run.trace.device_seconds_marked()
    return 1e3 * seconds / run.traced.units if seconds > 0.0 else None
