"""batch_sets: sets per lane batch over the window (the stack's lodestar_bls_verifier_sets_per_job histogram, window delta of sum over count)."""

from bm import layers


def read(ctx):
    return layers.sets_per_job(ctx)
