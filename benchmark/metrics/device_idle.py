"""device_idle: % of the profiled slice in which nothing ran on the card (one minus the union of device activity over the slice)."""

from bm import layers


def read(ctx):
    return layers.idle_share(ctx)
