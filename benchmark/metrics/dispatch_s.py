"""dispatch_s: host seconds to enqueue one verdict on the card (the pipeline's stage_snapshot, stage dispatch, window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "dispatch")
