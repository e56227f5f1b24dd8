"""torch_ops: PyTorch operators per verdict (top-level aten events on every thread inside the profiled slice's whole facade jobs, over those jobs)."""

from bm import layers


def read(ctx):
    return layers.ops_per_job(ctx)
