"""Device time per request of the copies between host and device
(`Memcpy HtoD` and `Memcpy DtoH` records): the request's inputs in and
the synthesized volume out."""


def read(run):
    seconds = run.trace.device_seconds_where(
        lambda name, cat: cat == "gpu_memcpy"
        and ("HtoD" in name or "DtoH" in name))
    return 1e3 * seconds / run.traced.units if seconds > 0.0 else None
