"""K2p and K3-fe, the main path's Miller loop and final exponentiation,
through their host build (`csrc/tower_host.cpp`: the kernels' own
arithmetic, `tower.cuh`, compiled with a C++ compiler), and the entries
that route to them.

Tolerance 0 everywhere (integer arithmetic). The kernels return canonical
limbs and the plain versions lazy ones, so they are compared by canonical
value: K2p uses the plain loop's formulas and line scalings, and K3-fe
inverts per lane where the plain batch form shares one inversion, which
gives the same field element.

- K2p on 3 projective lanes (valid G1/G2 points times random Z, every
  value in [p, 2p)) equals the port's `miller_loop_proj_pq` and the JAX
  package's (jit on the CPU); a Zp = 0 and a Zq = 0 lane return and are
  not compared;
- K3-fe on a random lane, a zero lane and the identity equals
  `final_exponentiation_batch`;
- the entries' CPU routing, broadcasting and scalar forms;
- the CUDA wrappers raise on CPU tensors;
- the host build's Fp multiply counts of the two new lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.bls import curve as oc
from lodestar_tpu.ops import pairing as jpairing
from lodestar_tpu.ops.io_host import g1_affine_to_limbs, g2_affine_to_limbs
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_tower, fp, fp12, pairing
from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs, limbs_to_int

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

R = R_MONT % P


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.int32))


def high(v: int) -> np.ndarray:
    """The Montgomery value v < p as limbs of v + p, in [p, 2p)."""
    return int_to_limbs(v + P)


def projective_lanes(n: int, seed: int):
    """n projective (P, Q) lanes: valid points from the JAX package's
    oracle times random Z (Zp ∈ Fp, Zq ∈ Fp2), every coordinate in
    Montgomery form and in [p, 2p). Returns (xp, yp, zp), (xq, yq, zq)."""
    rng = np.random.default_rng(seed)

    def rand_fp() -> int:
        return int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1

    p_rows, q_rows = [], []
    for _ in range(n):
        gx, gy = (limbs_to_int(c) for c in g1_affine_to_limbs(
            oc.PointG1.generator() * int(rng.integers(2, 2**62)))[:2])
        z = rand_fp()
        p_rows.append([high(gx * z % P), high(gy * z % P), high(z * R % P)])
        qx, qy = ([limbs_to_int(c[0]), limbs_to_int(c[1])] for c in g2_affine_to_limbs(
            oc.PointG2.generator() * int(rng.integers(2, 2**62)))[:2])
        z0, z1 = rand_fp(), rand_fp()

        def times_z(a):  # (a0 + a1 u)(z0 + z1 u), a in Montgomery form
            return [(a[0] * z0 - a[1] * z1) % P, (a[0] * z1 + a[1] * z0) % P]

        q_rows.append([np.stack([high(c) for c in times_z(qx)]),
                       np.stack([high(c) for c in times_z(qy)]),
                       np.stack([high(z0 * R % P), high(z1 * R % P)])])
    p = tuple(np.stack([r[k] for r in p_rows]).astype(np.int32) for k in range(3))
    q = tuple(np.stack([r[k] for r in q_rows]).astype(np.int32) for k in range(3))
    return p, q


def with_infinity_lanes(p, q):
    """Two more lanes: the first lane's points with Zp = 0, then with Zq = 0."""
    p = tuple(np.concatenate([c, c[:1], c[:1]]) for c in p)
    q = tuple(np.concatenate([c, c[:1], c[:1]]) for c in q)
    p[2][-2] = 0
    q[2][-1] = 0
    return p, q


def test_k2p_equals_the_ports_and_jaxs_miller_loop_proj_pq():
    p, q = projective_lanes(3, 31)
    assert all(limbs_to_int(c[i]) >= P for c in p for i in range(3))
    p5, q5 = with_infinity_lanes(p, q)
    got = cuda_tower.miller_loop_proj_host(*p5, *q5)
    assert got.shape == (5, 2, 3, 2, 32)
    plain = pairing.miller_loop_proj_pq(tuple(map(t, p)), tuple(map(t, q)))
    ref = jax.jit(jpairing.miller_loop_proj_pq)(tuple(map(jnp.asarray, p)),
                                                tuple(map(jnp.asarray, q)))
    np.testing.assert_array_equal(got[:3], canon(plain))
    np.testing.assert_array_equal(got[:3], canon(np.asarray(ref)))
    assert (got < 4096).all() and (got >= 0).all()  # the infinity lanes returned limbs


def test_k2p_is_the_affine_loop_at_z_one():
    """Zp = Zq = 1 (Montgomery one) is K2's affine loop, lane for lane."""
    p, q = projective_lanes(2, 32)
    one_p = np.stack([high(R)] * 2).astype(np.int32)
    one_q = np.stack([np.stack([high(R), int_to_limbs(0)])] * 2).astype(np.int32)
    got = cuda_tower.miller_loop_proj_host(p[0], p[1], one_p, q[0], q[1], one_q)
    np.testing.assert_array_equal(got, cuda_tower.miller_loop_host(p[0], p[1], q[0], q[1]))


def _fp12_lanes(seed: int):
    """A random Fp12 lane, the zero lane and the identity (Montgomery one)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(12)]
    rand = np.stack([int_to_limbs(v) for v in vals]).reshape(2, 3, 2, 32)
    one = fp12.one((), torch.device("cpu")).numpy()
    return np.stack([rand, np.zeros_like(rand), one]).astype(np.int32)


def test_k3fe_equals_final_exponentiation_batch_random_zero_identity():
    fs = _fp12_lanes(33)
    got = cuda_tower.final_exp_host(fs)
    plain = pairing.final_exponentiation_batch(t(fs))
    np.testing.assert_array_equal(got, canon(plain))
    assert (got[1] == 0).all()  # zero in, zero out
    ok = [bool(v) for v in fp12.is_one(torch.as_tensor(got))]
    assert ok == [False, False, True]


def test_entries_route_cpu_tensors_to_the_plain_versions():
    p, q = projective_lanes(1, 34)
    pt, qt = tuple(map(t, p)), tuple(map(t, q))
    np.testing.assert_array_equal(pairing.miller_loop_proj_pq(pt, qt).numpy(),
                                  cuda_tower.miller_loop_proj_plain(*pt, *qt).numpy())
    fs = t(_fp12_lanes(35))
    np.testing.assert_array_equal(pairing.final_exponentiation_batch(fs).numpy(),
                                  cuda_tower.final_exp_plain(fs).numpy())
    one = pairing.final_exponentiation_one(fs[0])
    assert one.shape == (2, 3, 2, 32)
    np.testing.assert_array_equal(canon(one), canon(pairing.final_exponentiation(fs[:1]))[0])
    assert cuda_tower.MILLER_PROJ_LAUNCHES == 0 and cuda_tower.FINAL_EXP_LAUNCHES == 0


def test_miller_loop_proj_kernel_broadcasts_and_takes_a_scalar_lane():
    p, q = projective_lanes(2, 36)
    pt, qt = tuple(map(t, p)), tuple(map(t, q))
    # one P against two Q lanes, broadcast
    got = cuda_tower.miller_loop_proj_kernel(tuple(c[:1] for c in pt), qt)
    want = cuda_tower.miller_loop_proj_host(*(np.repeat(c[:1], 2, 0) for c in p), *q)
    np.testing.assert_array_equal(canon(got), want)
    one = cuda_tower.miller_loop_proj_kernel(tuple(c[1] for c in pt), tuple(c[1] for c in qt))
    assert one.shape == (2, 3, 2, 32)
    np.testing.assert_array_equal(canon(one), cuda_tower.miller_loop_proj_host(
        *(c[1:] for c in p), *(c[1:] for c in q))[0])


def test_final_exp_kernel_keeps_leading_axes():
    fs = _fp12_lanes(37)
    two = np.stack([fs, fs[::-1]])  # (2, 3, 2, 3, 2, 32)
    got = cuda_tower.final_exp_kernel(t(two))
    assert got.shape == two.shape
    want = cuda_tower.final_exp_host(two.reshape(6, 2, 3, 2, 32)).reshape(two.shape)
    np.testing.assert_array_equal(canon(got), want)


def test_new_cuda_wrappers_raise_on_cpu_tensors():
    p = torch.zeros((2, 32), dtype=torch.int32)
    q = torch.zeros((2, 2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tower.miller_loop_proj_cuda(p, p, p, q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tower.final_exp_cuda(torch.zeros((2, 2, 3, 2, 32), dtype=torch.int32))
    assert cuda_tower.MILLER_PROJ_LAUNCHES == 0 and cuda_tower.FINAL_EXP_LAUNCHES == 0


@pytest.mark.parametrize("key, predicted", [("miller_loop_proj", 8_450), ("final_exp", 8_333)])
def test_fp_muls_per_lane_of_the_new_kernels(key, predicted):
    """Within 5 % of the counts predicted from K2's 8,282 (plus l0·Zp and
    the projective chord) and of a scratch count of K3's tail."""
    muls = cuda_tower.fp_muls_per_lane()
    assert abs(muls[key] - predicted) <= 0.05 * predicted
    assert muls["miller_loop"] < muls["miller_loop_proj"]
