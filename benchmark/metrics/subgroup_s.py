"""subgroup_s: host seconds to enqueue one plane subgroup check of a verdict (stage bls/plane_subgroup, named as its profiler scope; window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "bls/plane_subgroup")
