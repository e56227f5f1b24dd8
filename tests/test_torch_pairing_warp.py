"""K3, the fused per-set pairing, as `pairing_warp_kernel` runs it: two
Miller warps at unit Z, then the tail (the product, its conjugate and the
final exponentiation) on the first warp's slots, through its host build
with the warps emulated (`cuda_tower.pairing_warp_host`).

Tolerance 0 everywhere (integer arithmetic). The batch is 8 sets signed by
the host tier with the three tampered positions of `chip_smoke.per_set_tamper`
(a set with another set's message, signature and pubkey), plus an all-zero
set:

- the warp lane with the threads of every phase run 0..31 and 31..0 (and
  the two Miller warps in either order) agrees limb for limb: the slot
  buffer starts from a different pattern in each order, so a slot read
  before it is written, or read in the phase that writes it, shows;
- it equals the one-thread set that K3 replaced (`tower.cuh`
  `pairing_lane`, `pairing_fused_host`) and the canonical form of
  `pairing_fused_plain`, the zero set included (zero in, zero out);
- `fp12.is_one` of it gives the JAX package's host-tier verdicts
  (`lodestar_tpu.native.bls_verify_sets`);
- no thread multiplies twice in a phase, and a set's rounds are one
  Miller warp's 268, the product's 2 and the final exponentiation's 398;
- the bound counts the fewest Fp multiplies a set needs (`pairing_fewest`:
  the one-thread set's shared-chain Miller part plus `final_exp_fewest`),
  and `pairing_warp` is the schedule's;
- slow tier: the JAX package's `pairing_fused_pallas(interpret=True)` on
  one tile.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu import native as jnative
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.ops import cuda_tower, fp, fp12
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier
from lodestar_tpu_torch.profile_verdict import make_sets

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

N_SETS = 8
NAMES = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


@pytest.fixture(scope="module")
def batch():
    """The 8 tampered-batch sets and the zero set as limb columns, and the
    host tier's verdicts of the 8."""
    bad = make_sets(N_SETS, 1, seed=91, threads=1)
    for k, field in chip_smoke.per_set_tamper(N_SETS):
        bad = chip_smoke._tamper_one(bad, k, field, k - 1)
    arrs = TorchBlsVerifier(device="cpu")._marshal(bad)
    cols = [np.concatenate([getattr(arrs, k)[:N_SETS], np.zeros_like(getattr(arrs, k)[:1])])
            .astype(np.int32) for k in NAMES]
    host = jnative.bls_verify_sets(b"".join(s.pubkey.to_bytes() for s in bad),
                                   [s.message for s in bad],
                                   b"".join(s.signature for s in bad), DST_G2)
    return cols, host


@pytest.fixture(scope="module")
def warp(batch):
    cols, _ = batch
    cuda_tower.warp_stats(reset=True)
    fwd = cuda_tower.pairing_warp_host(*cols)
    rev = cuda_tower.pairing_warp_host(*cols, reverse=True)
    return fwd, rev, cuda_tower.warp_stats(reset=True)


def test_warp_orders_agree_limb_for_limb(warp):
    fwd, rev, _ = warp
    assert fwd.shape == (N_SETS + 1, 2, 3, 2, 32)
    np.testing.assert_array_equal(fwd, rev)


def test_warp_equals_the_one_thread_set_and_the_plain_pairing(batch, warp):
    cols, _ = batch
    fwd, _, _ = warp
    np.testing.assert_array_equal(fwd, cuda_tower.pairing_fused_host(*cols))
    plain = cuda_tower.pairing_fused_plain(*map(torch.as_tensor, cols))
    np.testing.assert_array_equal(fwd, canon(plain))
    assert (fwd[N_SETS] == 0).all()  # the zero set: zero in, zero out
    assert (fwd >= 0).all() and (fwd < 4096).all()


def test_verdicts_equal_the_host_tier(batch, warp):
    _, host = batch
    fwd, _, _ = warp
    ok = [bool(v) for v in fp12.is_one(torch.as_tensor(fwd))]
    assert ok == list(host) + [False]
    tampered = {k for k, _ in chip_smoke.per_set_tamper(N_SETS)}
    assert [i for i, v in enumerate(host) if not v] == sorted(tampered)


def test_no_thread_multiplies_twice_in_a_phase(warp):
    fwd, _, stats = warp
    muls = cuda_tower.fp_muls_per_lane()
    runs = 2 * fwd.shape[0]
    assert stats["overfull"] == 0
    # both Miller warps' rounds are counted here; they run side by side
    per_set = muls["pairing_warp_rounds"] + muls["miller_loop_proj_warp_rounds"]
    assert stats["rounds"] == runs * per_set


def test_rounds_are_one_miller_warp_the_product_and_the_final_exponentiation():
    muls = cuda_tower.fp_muls_per_lane()
    assert muls["pairing_warp_rounds"] == (muls["miller_loop_proj_warp_rounds"] + 2
                                           + muls["final_exp_warp_rounds"]) == 268 + 2 + 398


def test_fp_muls_of_the_bound_and_of_the_schedule():
    """The bound: the one-thread set's 22,629 less its final
    exponentiation's 8,333 (the two Miller loops on one squaring chain),
    plus the 7,724 the final exponentiation needs. The schedule: two
    Miller warps of 8,182, the Fp12 product's 54 and K3-fe's 10,562."""
    muls = cuda_tower.fp_muls_per_lane()
    assert muls["pairing_fewest"] == (muls["pairing_fused"] - muls["final_exp"]
                                      + muls["final_exp_fewest"]) == 22_020
    assert muls["pairing_warp"] == (2 * muls["miller_loop_proj_warp"] + 54
                                    + muls["final_exp_warp"]) == 26_980


@pytest.mark.slow
def test_warp_equals_jax_pairing_fused_pallas_one_tile(batch):
    import jax.numpy as jnp

    from lodestar_tpu.ops import pallas_tower

    cols = [c[[3, 4, 5, N_SETS]] for c in batch[0]]  # valid, two tampered, zero
    j = [jnp.asarray(c) for c in cols]
    ref = pallas_tower.pairing_fused_pallas((j[0], j[1]), (j[2], j[3]), (j[4], j[5]),
                                            interpret=True)
    np.testing.assert_array_equal(cuda_tower.pairing_warp_host(*cols), canon(np.asarray(ref)))
