"""device_ms: kernel milliseconds per verdict, every kernel including PyTorch's own, inside the profiled slice's whole facade jobs."""

from bm import layers


def read(ctx):
    return layers.device_ms_per_job(ctx)
