"""K3-fe's warp schedule (`csrc/tower_warp.cuh`) through its host build,
the warp emulated one thread after another (`cuda_tower.final_exp_warp_host`),
and its Euclid inverse (`cuda_tower.fp_inv_host`).

Tolerance 0 everywhere (integer arithmetic):

- the final exponentiation with the threads of every phase run 0..31 and
  31..0 equals, limb for limb, the one-thread lane that K3 keeps
  (`final_exp_host`) and the canonical form of `final_exp_plain`: the two
  orders agree only if no thread of a phase reads what another one writes
  in it, and the slot buffer starts from a different pattern in each
  order, so a slot read before it is written shows too;
- no thread multiplies twice in a phase, and a lane's dependent rounds
  stay within 10 % of the 398 predicted in PERF.md before the kernel
  first ran;
- K3-fe's FIOS multiply equals the plain Montgomery product in canonical
  form on the edges and 64 random pairs;
- the bound's count (`final_exp_fewest`) is the one-thread lane's with
  the Euclid inverse in place of Fermat's chain, and `profile_fe`'s
  operation counts give the schedule's multiplies and rounds;
- the binary extended Euclid inverse equals the Fermat inverse limb for
  limb on 0, 1, Montgomery 1 (R mod p), p − 1, the Montgomery form of R
  (R² mod p) and 64 random values, and each nonzero inverse times its
  input is Montgomery 1;
- slow tier: the JAX package's `final_exponentiation_batch` on 2 lanes.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_tower, fp, fp12, pairing
from lodestar_tpu_torch.ops.limbs import ONE_MONT_LIMBS, R_MONT, int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

PREDICTED_ROUNDS = 398  # PERF.md: K3-fe's prediction before its first chip run
EDGES = [0, 1, P - 1, P, 2 * P - 1]


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


def fp12_lanes(seed: int) -> np.ndarray:
    """Two random Fp12 lanes of values in [0, 2p), the edges 0, 1, p − 1,
    p and 2p − 1 among the second one's coefficients, then the zero lane
    and the identity (Montgomery one)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(24)]
    vals[12 + 1:12 + 1 + 2 * len(EDGES):2] = EDGES
    rand = np.stack([int_to_limbs(v) for v in vals]).reshape(2, 2, 3, 2, 32)
    one = fp12.one((), torch.device("cpu")).numpy()
    return np.concatenate([rand, np.zeros_like(rand[:1]), one[None]]).astype(np.int32)


@pytest.fixture(scope="module")
def lanes_and_warp():
    fs = fp12_lanes(71)
    cuda_tower.warp_stats(reset=True)
    fwd = cuda_tower.final_exp_warp_host(fs)
    rev = cuda_tower.final_exp_warp_host(fs, reverse=True)
    return fs, fwd, rev, cuda_tower.warp_stats(reset=True)


def test_warp_orders_agree_limb_for_limb(lanes_and_warp):
    _, fwd, rev, _ = lanes_and_warp
    np.testing.assert_array_equal(fwd, rev)


def test_warp_equals_the_one_thread_lane(lanes_and_warp):
    fs, fwd, _, _ = lanes_and_warp
    np.testing.assert_array_equal(fwd, cuda_tower.final_exp_host(fs))


def test_warp_equals_final_exponentiation_batch(lanes_and_warp):
    fs, fwd, _, _ = lanes_and_warp
    np.testing.assert_array_equal(fwd, canon(cuda_tower.final_exp_plain(torch.as_tensor(fs))))
    assert (fwd[2] == 0).all()  # zero in, zero out
    ok = [bool(v) for v in fp12.is_one(torch.as_tensor(fwd))]
    assert ok == [False, False, False, True]
    assert (fwd >= 0).all() and (fwd < 4096).all()


def test_no_thread_multiplies_twice_in_a_phase(lanes_and_warp):
    fs, _, _, stats = lanes_and_warp
    lanes = 2 * fs.shape[0]
    assert stats["overfull"] == 0
    assert stats["rounds"] % lanes == 0 and stats["phases"] % lanes == 0
    assert stats["rounds"] // lanes == cuda_tower.fp_muls_per_lane()["final_exp_warp_rounds"]


def test_rounds_within_ten_percent_of_the_prediction():
    muls = cuda_tower.fp_muls_per_lane()
    assert abs(muls["final_exp_warp_rounds"] - PREDICTED_ROUNDS) <= 0.1 * PREDICTED_ROUNDS


def test_fp_muls_of_the_warp_lane():
    """35 Fp12 products of 54 Fp products, 315 cyclotomic squarings of 27,
    3 Frobenius maps of 18, and the inversion's 113 (Fp6 products 2 x 36,
    Fp2 products 18 + 9 + 9, Fp2 inverse 2 + 2, the Euclid inverse's
    multiply by R^3): no Fermat chain."""
    muls = cuda_tower.fp_muls_per_lane()
    assert muls["final_exp_warp"] == 35 * 54 + 315 * 27 + 3 * 18 + 113


def test_fewest_fp_muls_are_the_one_thread_lane_with_the_euclid_inverse():
    """The bound counts what the function needs, not the warp schedule's
    redundant products: 315 cyclotomic squarings of 18 products and 35
    Fp12 products of 54 at least, Fermat's 610 multiplies replaced by the
    Euclid inverse's one."""
    muls = cuda_tower.fp_muls_per_lane()
    assert muls["final_exp_fewest"] == muls["final_exp"] - 610 + 1
    assert 315 * 18 + 35 * 54 < muls["final_exp_fewest"] < muls["final_exp_warp"]


def test_profile_fe_counts_give_the_schedule():
    """profile_fe's operations per lane, times each operation's products
    (and rounds), add up to the host build's counts: 54 (2) per Fp12
    product, 27 (1) per cyclotomic squaring, 18 (1) per Frobenius, 113
    (10) for the inversion."""
    from lodestar_tpu_torch.profile_fe import lane_op_counts

    c = lane_op_counts()
    muls = cuda_tower.fp_muls_per_lane()
    assert c["cyclotomic_sqr"] == 315 and c["fp12_mul"] == 35 and c["fp12_inv"] == 1
    assert (54 * c["fp12_mul"] + 27 * c["cyclotomic_sqr"] + 18 * c["frobenius"] + 113
            == muls["final_exp_warp"])
    assert (2 * c["fp12_mul"] + c["cyclotomic_sqr"] + c["frobenius"] + 10
            == muls["final_exp_warp_rounds"])


MUL_EDGES = [0, 1, 2, R_MONT % P, P - 1, P - 2, (P - 1) // 2]


@pytest.mark.parametrize("case", ["edges", "random"])
def test_fios_multiply_equals_the_plain_montgomery_product(case):
    """K3-fe's FIOS multiply against `fp.mul` (the REDC that K1's CIOS
    equals limb for limb), reduced to canonical form."""
    if case == "edges":
        pairs = [(a, b) for a in MUL_EDGES for b in MUL_EDGES]
    else:
        rng = np.random.default_rng(75)
        pairs = [(int.from_bytes(rng.bytes(48), "little") % P,
                  int.from_bytes(rng.bytes(48), "little") % P) for _ in range(64)]
    a = np.stack([int_to_limbs(x) for x, _ in pairs]).astype(np.int32)
    b = np.stack([int_to_limbs(y) for _, y in pairs]).astype(np.int32)
    fios = cuda_tower.fp_mul_host(a, b)
    want = canon(fp.mul(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_array_equal(fios, want)


def test_entry_routes_cpu_tensors_to_the_plain_version():
    fs = torch.as_tensor(fp12_lanes(72))
    np.testing.assert_array_equal(cuda_tower.final_exp_kernel(fs).numpy(),
                                  cuda_tower.final_exp_plain(fs).numpy())
    np.testing.assert_array_equal(pairing.final_exponentiation_batch(fs).numpy(),
                                  cuda_tower.final_exp_plain(fs).numpy())
    assert cuda_tower.FINAL_EXP_LAUNCHES == 0


EUCLID_EDGES = {
    "zero": 0,
    "one": 1,
    "montgomery_one": R_MONT % P,
    "p_minus_1": P - 1,
    "montgomery_r": R_MONT * R_MONT % P,
}


def _check_inverses(vals: list[int]):
    x = np.stack([int_to_limbs(v) for v in vals]).astype(np.int32)
    euclid = cuda_tower.fp_inv_host(x)
    np.testing.assert_array_equal(euclid, cuda_tower.fp_inv_host(x, euclid=False))
    nz = np.array([v % P != 0 for v in vals])
    if nz.any():
        prod = fp.canonical(fp.mul(torch.as_tensor(euclid[nz]), torch.as_tensor(x[nz]))).numpy()
        np.testing.assert_array_equal(prod, np.broadcast_to(ONE_MONT_LIMBS, prod.shape))
    if not nz.all():
        assert (euclid[~nz] == 0).all()


@pytest.mark.parametrize("name", sorted(EUCLID_EDGES))
def test_euclid_inverse_on_edges(name):
    _check_inverses([EUCLID_EDGES[name]])


def test_euclid_inverse_on_64_random_values():
    rng = np.random.default_rng(73)
    _check_inverses([int.from_bytes(rng.bytes(48), "little") % P for _ in range(64)])


@pytest.mark.slow
def test_warp_equals_jax_final_exponentiation_batch():
    import jax.numpy as jnp

    from lodestar_tpu.ops import pairing as jpairing

    fs = fp12_lanes(74)[[0, 3]]
    ref = np.asarray(jpairing.final_exponentiation_batch(jnp.asarray(fs)))
    np.testing.assert_array_equal(cuda_tower.final_exp_warp_host(fs), canon(ref))
