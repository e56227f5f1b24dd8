"""kernel_roofline: the tower kernels' (K2p, K3-fe, K3) summed bound time over their summed device time in the profiled slice, in %."""

from bm import layers


def read(ctx):
    return layers.kernel_roofline(ctx)
