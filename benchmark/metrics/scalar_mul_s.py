"""scalar_mul_s: host seconds to enqueue one scalar-multiplication stage of a verdict (stage bls/scalar_mul, named as its profiler scope; window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "bls/scalar_mul")
