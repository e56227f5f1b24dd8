"""K2p's warp schedule (`csrc/miller_warp.cuh` over the phase tables of
`csrc/miller_sched.cuh`) through its host build, the warp emulated one
thread after another (`cuda_tower.miller_loop_proj_warp_host`), and the
generator of its tables (`gen_miller_sched`).

Tolerance 0 everywhere (integer arithmetic). The lanes are valid G1 and G2
points (the generators doubled a number of times drawn from a numpy seed)
times random Z (Zp ∈ Fp, Zq ∈ Fp2), every coordinate in Montgomery form
and in [p, 2p), plus the first lane with Zp = 0 and with Zq = 0:

- the projective Miller loop with the threads of every phase run 0..31
  and 31..0 agrees limb for limb: the slot buffer starts from a different
  pattern in each order, so a slot read before it is written, or read in
  the phase that writes it, shows as a difference;
- both equal, limb for limb, the one-thread lane that K2p replaced
  (`tower.cuh` `miller_proj_lane`, `miller_loop_proj_host`), and the
  canonical form of `miller_loop_proj_plain`, on every lane;
- at Zp = Zq = 1 they are K2's affine loop (`miller_loop_host`);
- no thread multiplies twice in a phase, and a lane's dependent rounds
  stay within 10 % of the 268 predicted in PERF.md before the kernel first
  ran;
- the committed tables are the generator's output, and the generator
  refuses a phase that reads a slot it writes;
- slow tier: the JAX package's `miller_loop_proj_pq` on 2 lanes.
"""

import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch import gen_miller_sched
from lodestar_tpu_torch.bls.curve import PointG1, PointG2
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_tower, fp, pairing
from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

PREDICTED_ROUNDS = 268  # PERF.md: K2p's prediction before its first chip run
CSRC = os.path.join(os.path.dirname(gen_miller_sched.__file__), "csrc")
R = R_MONT % P


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


def high(v: int) -> np.ndarray:
    """The Montgomery form of v as limbs of vR mod p + p, in [p, 2p)."""
    return int_to_limbs(v * R % P + P)


def _doubled(point, k: int):
    for _ in range(k):
        point = point.double()
    return point.to_affine()


def projective_lanes(n: int, seed: int, z_one: bool = False):
    """n projective (P, Q) lanes, then the first lane with Zp = 0 and with
    Zq = 0 (not with `z_one`: then Z = 1 everywhere). Returns
    ((xp, yp, zp), (xq, yq, zq)) as int32 limb arrays."""
    rng = np.random.default_rng(seed)

    def rand_fp() -> int:
        return 1 if z_one else int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1

    p_rows, q_rows = [], []
    for _ in range(n):
        gx, gy = (c.n for c in _doubled(PointG1.generator(), int(rng.integers(1, 40))))
        z = rand_fp()
        p_rows.append([high(gx * z), high(gy * z), high(z)])
        qx, qy = _doubled(PointG2.generator(), int(rng.integers(1, 40)))
        z0, z1 = rand_fp(), 0 if z_one else rand_fp()

        def times_z(a):  # (a0 + a1 u)(z0 + z1 u)
            return [a.c0.n * z0 - a.c1.n * z1, a.c0.n * z1 + a.c1.n * z0]

        q_rows.append([np.stack([high(c) for c in times_z(qx)]),
                       np.stack([high(c) for c in times_z(qy)]),
                       np.stack([high(z0), high(z1)])])
    p = [np.stack([r[k] for r in p_rows]).astype(np.int32) for k in range(3)]
    q = [np.stack([r[k] for r in q_rows]).astype(np.int32) for k in range(3)]
    if not z_one:
        p = [np.concatenate([c, c[:1], c[:1]]) for c in p]
        q = [np.concatenate([c, c[:1], c[:1]]) for c in q]
        p[2][n] = 0
        q[2][n + 1] = 0
    return tuple(p), tuple(q)


@pytest.fixture(scope="module")
def lanes_and_warp():
    p, q = projective_lanes(3, 81)
    cuda_tower.warp_stats(reset=True)
    fwd = cuda_tower.miller_loop_proj_warp_host(*p, *q)
    rev = cuda_tower.miller_loop_proj_warp_host(*p, *q, reverse=True)
    return p, q, fwd, rev, cuda_tower.warp_stats(reset=True)


def test_warp_orders_agree_limb_for_limb(lanes_and_warp):
    _, _, fwd, rev, _ = lanes_and_warp
    assert fwd.shape == (5, 2, 3, 2, 32)
    np.testing.assert_array_equal(fwd, rev)


def test_warp_equals_the_one_thread_lane(lanes_and_warp):
    p, q, fwd, _, _ = lanes_and_warp
    np.testing.assert_array_equal(fwd, cuda_tower.miller_loop_proj_host(*p, *q))


def test_warp_equals_miller_loop_proj_plain(lanes_and_warp):
    """Every lane, the Zp = 0 and Zq = 0 lanes too: nothing divides, so
    they give the plain loop's value as well."""
    p, q, fwd, _, _ = lanes_and_warp
    plain = cuda_tower.miller_loop_proj_plain(*map(torch.as_tensor, p), *map(torch.as_tensor, q))
    np.testing.assert_array_equal(fwd, canon(plain))
    assert (fwd >= 0).all() and (fwd < 4096).all()


def test_warp_is_the_affine_loop_at_z_one():
    """Zp = Zq = 1 (Montgomery one) is K2's affine loop, lane for lane."""
    p, q = projective_lanes(2, 82, z_one=True)
    got = cuda_tower.miller_loop_proj_warp_host(*p, *q)
    np.testing.assert_array_equal(got, cuda_tower.miller_loop_host(p[0], p[1], q[0], q[1]))


def test_no_thread_multiplies_twice_in_a_phase(lanes_and_warp):
    _, _, fwd, _, stats = lanes_and_warp
    lanes = 2 * fwd.shape[0]
    assert stats["overfull"] == 0
    assert stats["rounds"] % lanes == 0 and stats["phases"] % lanes == 0
    counts = gen_miller_sched.counts()
    assert stats["rounds"] // lanes == counts["rounds"]
    assert stats["phases"] // lanes == counts["phases"]


def test_rounds_within_ten_percent_of_the_prediction():
    muls = cuda_tower.fp_muls_per_lane()
    assert abs(muls["miller_loop_proj_warp_rounds"] - PREDICTED_ROUNDS) <= 0.1 * PREDICTED_ROUNDS


def test_fp_muls_of_the_warp_lane():
    """The schedule runs the products the generator put in its tables;
    the bound counts the fewer of it and the one-thread lane."""
    muls = cuda_tower.fp_muls_per_lane()
    counts = gen_miller_sched.counts()
    assert muls["miller_loop_proj_warp"] == counts["fp_muls"]
    assert muls["miller_loop_proj_warp_rounds"] == counts["rounds"]
    assert muls["miller_loop_proj_fewest"] == min(muls["miller_loop_proj"],
                                                  muls["miller_loop_proj_warp"])
    # the set-up: 8 products by zp, -xp, yp and the first doubling's level
    # A (23); a doubling: the squaring's 36, the line's second level (24),
    # the line product's 39 and the next step's level A (23, or 24 before
    # an addition); an addition: its second level (30), 39 and 23
    assert counts["fp_muls"] == (8 + 23) + 58 * (36 + 24 + 39 + 23) + 5 * (36 + 24 + 39 + 24) \
        + 5 * (30 + 39 + 23)


def test_committed_tables_are_the_generators_output():
    with open(os.path.join(CSRC, "miller_sched.cuh")) as f:
        assert f.read() == gen_miller_sched.render()


def test_generator_refuses_a_phase_that_reads_what_it_writes():
    t = gen_miller_sched.Template("conflict")
    t.lin(stores=[(gen_miller_sched.S_T, gen_miller_sched.s(gen_miller_sched.S_T + 1)),
                  (gen_miller_sched.S_T + 1, gen_miller_sched.s(gen_miller_sched.S_Q))])
    t.mul([(gen_miller_sched.s(gen_miller_sched.S_T), gen_miller_sched.s(gen_miller_sched.S_T))],
          outs=[gen_miller_sched.S_T + 2])
    with pytest.raises(ValueError, match="reads a slot it writes"):
        gen_miller_sched.records([t])


def test_entry_routes_cpu_tensors_to_the_plain_version():
    p, q = projective_lanes(1, 83)
    pt, qt = tuple(map(torch.as_tensor, p)), tuple(map(torch.as_tensor, q))
    np.testing.assert_array_equal(pairing.miller_loop_proj_pq(pt, qt).numpy(),
                                  cuda_tower.miller_loop_proj_plain(*pt, *qt).numpy())
    assert cuda_tower.MILLER_PROJ_LAUNCHES == 0


@pytest.mark.slow
def test_warp_equals_jax_miller_loop_proj_pq():
    import jax.numpy as jnp

    from lodestar_tpu.ops import pairing as jpairing

    p, q = projective_lanes(2, 84)
    p, q = tuple(c[:2] for c in p), tuple(c[:2] for c in q)
    ref = np.asarray(jpairing.miller_loop_proj_pq(tuple(map(jnp.asarray, p)),
                                                  tuple(map(jnp.asarray, q))))
    np.testing.assert_array_equal(cuda_tower.miller_loop_proj_warp_host(*p, *q), canon(ref))
