"""audit_s: host-tier seconds of one negative audit of a device False (stage audit, window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.stage_seconds_per_count(ctx, "audit")
