"""lane_wait_s: seconds a call waited in its lane before its batch left (the pipeline's stage_snapshot, stage lane_wait, window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "lane_wait")
