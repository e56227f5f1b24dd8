"""bisect_s: host seconds of bisection's probe rounds after a failed tree root (stage bisect), per per-set call (planner decisions individual), over the window."""

from bm import layers


def read(ctx):
    return layers.bisect_seconds_per_call(ctx)
