"""K2 and K3, the Miller-loop and fused-pairing kernels, through their host
build (`csrc/tower_host.cpp`: the kernels' own arithmetic, `tower.cuh`,
compiled with a C++ compiler), and the pairing entries around them.

Tolerance 0 everywhere (integer arithmetic). The kernels return canonical
limbs and the plain versions lazy ones, so they are compared by canonical
value: K2 uses the plain version's formulas, and K3 inverts per lane where
the plain version shares one inversion, which gives the same field element.

- the generated constants header equals its generator's output;
- K2 on 3 lanes (one all zero) equals the port's plain `miller_loop` and
  the JAX package's `pallas_tower.miller_loop_pallas(..., interpret=True)`;
- K3 on 4 sets (one invalid, one zero lane) equals `pairing_fused_plain`
  and gives the host C tier's per-set verdicts;
- the kernels' final exponentiation equals the port's per-lane
  `final_exponentiation` (zero lane included); `pairing_check` and
  `miller_loop`'s scalar form on the CPU; the CUDA wrappers raise on CPU
  tensors.
- Slow tier: `pairing_fused_pallas(interpret=True)` on one tile against
  the host build.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.bls import curve as oc
from lodestar_tpu.ops import pallas_tower
from lodestar_tpu.ops.io_host import g1_affine_to_limbs, g2_affine_to_limbs
from lodestar_tpu_torch import gen_tower_consts
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_tower, fp, fp12, pairing
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "lodestar_tpu_torch", "csrc")


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.int32))


def miller_lanes(n: int, seed: int):
    """n affine (P, Q) lanes from the JAX package's oracle; the last one all
    zero."""
    rng = np.random.default_rng(seed)
    ps = [oc.PointG1.generator() * int(rng.integers(2, 2**62)) for _ in range(n)]
    qs = [oc.PointG2.generator() * int(rng.integers(2, 2**62)) for _ in range(n)]
    g1l = [g1_affine_to_limbs(p) for p in ps]
    g2l = [g2_affine_to_limbs(q) for q in qs]
    xp = np.stack([g[0] for g in g1l]).astype(np.int32)
    yp = np.stack([g[1] for g in g1l]).astype(np.int32)
    xq = np.stack([g[0] for g in g2l]).astype(np.int32)
    yq = np.stack([g[1] for g in g2l]).astype(np.int32)
    for a in (xp, yp, xq, yq):
        a[-1] = 0
    return xp, yp, xq, yq


def test_constants_header_is_the_generators_output():
    with open(os.path.join(CSRC, "tower_consts.cuh")) as f:
        assert f.read() == gen_tower_consts.render()


def test_k2_equals_plain_and_jax_interpret_three_lanes():
    xp, yp, xq, yq = miller_lanes(3, 11)
    got = cuda_tower.miller_loop_host(xp, yp, xq, yq)
    plain = pairing.miller_loop((t(xp), t(yp)), (t(xq), t(yq)))
    ref = pallas_tower.miller_loop_pallas(
        (jnp.asarray(xp), jnp.asarray(yp)), (jnp.asarray(xq), jnp.asarray(yq)), interpret=True)
    np.testing.assert_array_equal(got, canon(plain))
    np.testing.assert_array_equal(got, canon(np.asarray(ref)))
    assert (got[-1] == 0).all()  # the zero lane: zero lines make f zero


def _four_sets():
    """4 marshalled sets: set 1 signs another message, set 3 is all zero."""
    sks = [bls.interop_secret_key(20 + i) for i in range(4)]
    msgs = [bytes([0x30 + i]) * 32 for i in range(4)]
    sigs = [jnative.bls_sign(sk.to_bytes(), m, DST_G2)[1] for sk, m in zip(sks, msgs)]
    sigs[1] = jnative.bls_sign(sks[1].to_bytes(), b"\x77" * 32, DST_G2)[1]
    pks = b"".join(sk.to_public_key().to_bytes() for sk in sks)
    arrs = jnative.bls_marshal_sets(pks, b"".join(msgs), b"".join(sigs), DST_G2)
    cols = [np.array(a[:4]).astype(np.int32) for a in arrs[:6]]
    for a in cols:
        a[3] = 0
    host = jnative.bls_verify_sets(pks, msgs, b"".join(sigs), DST_G2)
    return cols, host


def test_k3_equals_plain_and_the_host_tier_four_sets():
    cols, host = _four_sets()
    got = cuda_tower.pairing_fused_host(*cols)
    plain = cuda_tower.pairing_fused_plain(*map(t, cols))
    np.testing.assert_array_equal(got, canon(plain))
    ok = [bool(v) for v in fp12.is_one(torch.as_tensor(got))]
    assert ok[:3] == host[:3] == [True, False, True]
    assert not ok[3] and (got[3] == 0).all()  # zero in, zero out


def test_final_exponentiation_per_lane_equals_the_kernels():
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
    fs = np.stack([np.stack([int_to_limbs(v) for v in vals]).reshape(2, 3, 2, 32),
                   np.zeros((2, 3, 2, 32), np.int32)])
    got = cuda_tower.final_exp_host(fs)
    np.testing.assert_array_equal(got, canon(pairing.final_exponentiation(t(fs))))
    assert (got[1] == 0).all()


def test_pairing_check_bilinearity():
    """e(P, Q)·e(−P, Q) = 1, and not with another Q in the second pair."""
    xp, yp, xq, yq = miller_lanes(2, 13)
    neg_yp = fp.neg(t(yp[0]))
    p_x = torch.stack([t(xp[0]), t(xp[0])])
    p_y = torch.stack([t(yp[0]), neg_yp])
    valid = torch.tensor([True, True])
    same = pairing.pairing_check((p_x, p_y), (t(xq[[0, 0]]), t(yq[[0, 0]])), valid)
    other = pairing.pairing_check((p_x, p_y), (t(xq[[0, 1]]), t(yq[[0, 1]])),
                                  torch.tensor([True, True]))
    assert bool(same) and not bool(other)
    assert bool(pairing.pairing_check((p_x[:0], p_y[:0]), (t(xq[:0]), t(yq[:0])), valid[:0]))


def test_miller_loop_scalar_call_gets_a_unit_batch():
    xp, yp, xq, yq = miller_lanes(1, 14)
    one = pairing.miller_loop((t(xp[0]), t(yp[0])), (t(xq[0]), t(yq[0])))
    assert one.shape == (2, 3, 2, 32)
    np.testing.assert_array_equal(canon(one), cuda_tower.miller_loop_host(xp, yp, xq, yq)[0])


def test_cuda_wrappers_raise_on_cpu_tensors():
    p = torch.zeros((2, 32), dtype=torch.int32)
    q = torch.zeros((2, 2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tower.miller_loop_cuda(p, p, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tower.pairing_fused_cuda(p, p, q, q, q, q)
    assert cuda_tower.MILLER_LAUNCHES == 0 and cuda_tower.PAIRING_LAUNCHES == 0


def test_fp_muls_per_lane_are_counted():
    muls = cuda_tower.fp_muls_per_lane()
    # 63 doubling steps and 5 additions, then (K3) a second loop sharing
    # the squarings and the final exponentiation: thousands each
    assert 5_000 < muls["miller_loop"] < muls["pairing_fused"] < 40_000


@pytest.mark.slow
def test_pallas_fused_pairing_one_tile_equals_the_host_build():
    cols, _ = _four_sets()
    ref = pallas_tower.pairing_fused_pallas(
        (jnp.asarray(cols[0]), jnp.asarray(cols[1])),
        (jnp.asarray(cols[2]), jnp.asarray(cols[3])),
        (jnp.asarray(cols[4]), jnp.asarray(cols[5])), interpret=True)
    np.testing.assert_array_equal(cuda_tower.pairing_fused_host(*cols), canon(np.asarray(ref)))
