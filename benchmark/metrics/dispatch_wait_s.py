"""dispatch_wait_s: seconds a device call waited for the supervisor's one dispatch thread (stage dispatch_wait, window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "dispatch_wait")
