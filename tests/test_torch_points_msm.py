"""The port's curve ops (`ops/points.py`) and bit-plane MSM (`ops/msm.py`).

Point ops are held limb for limb against the JAX package's
`lodestar_tpu.ops.points` (the same random projective inputs, tolerance
0). The MSM building blocks are held by canonical affine value against
the CPU oracle `lodestar_tpu.bls.curve` at R ≤ 2 rows, L = 4 lanes; the
limb-exact comparison against `lodestar_tpu.ops.msm` compiles the deep
JAX graphs and sits in the slow tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.bls.curve import PointG1, PointG2
from lodestar_tpu.bls.fields import Fq, Fq2
from lodestar_tpu.ops import io_host as jio
from lodestar_tpu.ops import msm as jmsm
from lodestar_tpu.ops import points as jpoints
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import msm, points
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

CURVES = {"g1": (points.g1, jpoints.g1, (32,)), "g2": (points.g2, jpoints.g2, (2, 32))}


def rand(seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(n)]
    return np.stack([int_to_limbs(v) for v in vals]).reshape(tuple(shape) + (32,))


def t(x):
    return torch.as_tensor(np.array(x))


def same_pt(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def rand_pt(seed, n, coord):
    return tuple(rand(seed + k, (n,) + coord[:-1]) for k in range(3))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_add_double_neg(name):
    ours, theirs, coord = CURVES[name]
    p, q = rand_pt(1, 3, coord), rand_pt(4, 3, coord)
    same_pt(ours.add(tuple(map(t, p)), tuple(map(t, q))),
            jax.jit(theirs.add)(tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q))))
    same_pt(ours.double(tuple(map(t, p))), jax.jit(theirs.double)(tuple(map(jnp.asarray, p))))
    same_pt(ours.neg(tuple(map(t, p))), theirs.neg(tuple(map(jnp.asarray, p))))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_select_infinity_is_infinity(name):
    ours, theirs, coord = CURVES[name]
    p = rand_pt(7, 4, coord)
    inf = ours.infinity((4,))
    same_pt(inf, theirs.infinity((4,)))
    cond = np.array([True, False, True, False])
    mixed = ours.select(torch.as_tensor(cond), tuple(map(t, p)), inf)
    same_pt(mixed, theirs.select(jnp.asarray(cond), tuple(map(jnp.asarray, p)), theirs.infinity((4,))))
    np.testing.assert_array_equal(ours.is_infinity(mixed).numpy(), ~cond)


def test_g2_psi():
    p = rand_pt(10, 3, (2, 32))
    same_pt(points.g2_psi(tuple(map(t, p))), jax.jit(jpoints.g2_psi)(tuple(map(jnp.asarray, p))))


# --- MSM by canonical affine value against the oracle ----------------------

def oracle_points(kind, seed, n):
    rng = np.random.default_rng(seed)
    gen = PointG1.generator() if kind == "g1" else PointG2.generator()
    return [gen * int(rng.integers(1, 2**32)) for _ in range(n)]


def to_limbs(kind, pts):
    conv = jio.g1_affine_to_limbs if kind == "g1" else jio.g2_affine_to_limbs
    xs, ys = zip(*(conv(p)[:2] for p in pts))
    x, y = np.stack(xs), np.stack(ys)
    curve = CURVES[kind][0]
    return (t(x), t(y), curve.F.one(tuple(x.shape[: x.ndim - curve.coord_ndim])))


def affine(kind, pt, idx):
    """Oracle affine value of the port's projective point at batch index."""
    x, y, z = (c[idx].numpy() for c in pt)
    if kind == "g1":
        X, Y, Z = (jio.limbs_to_fq(c) for c in (x, y, z))
        zero = Fq(0)
    else:
        X, Y, Z = (jio.limbs_to_fq2(c) for c in (x, y, z))
        zero = Fq2.zero()
    if Z == zero:
        return None
    zi = Z.inverse()
    return (X * zi, Y * zi)


def oracle_sum(pts):
    acc = pts[0] - pts[0]
    for p in pts:
        acc = acc + p
    return acc.to_affine()


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_tree_sum_and_subset_table(kind):
    curve = CURVES[kind][0]
    pts = oracle_points(kind, 20, 4)
    p = to_limbs(kind, pts)
    total = msm.tree_sum(curve, p)
    assert affine(kind, tuple(c[None] for c in total), 0) == oracle_sum(pts)
    table = msm.subset_table4(curve, p)
    for m in range(16):
        chosen = [pts[k] for k in range(4) if m >> k & 1]
        want = oracle_sum(chosen) if chosen else None
        assert affine(kind, table, m) == want, m


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_masked_plane_sums_and_horner(kind):
    curve = CURVES[kind][0]
    rows = 2 if kind == "g1" else 1
    pts = [oracle_points(kind, 30 + r, 4) for r in range(rows)]
    p = tuple(torch.stack(c) for c in zip(*(to_limbs(kind, row) for row in pts)))
    bits = np.random.default_rng(31).integers(0, 2, size=(rows, 4, 6)).astype(np.int32)
    bits[0, :, 0] = 0  # an empty plane sums to infinity
    planes = msm.masked_plane_sums(curve, p, torch.as_tensor(bits))  # (T, rows, *coord)
    for tt in range(6):
        for r in range(rows):
            chosen = [pts[r][k] for k in range(4) if bits[r, k, tt]]
            got = affine(kind, tuple(c[tt] for c in planes), r)
            assert got == (oracle_sum(chosen) if chosen else None), (tt, r)
    acc = msm.horner_pow2(curve, planes)
    for r in range(rows):
        scalars = [sum(int(bits[r, k, tt]) << tt for tt in range(6)) for k in range(4)]
        want = oracle_sum([pts[r][k] * s for k, s in enumerate(scalars) if s])
        assert affine(kind, acc, r) == want


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_msm_limb_exact_against_jax(kind):
    ours, theirs, coord = CURVES[kind]
    rows = 2
    p = tuple(rand(40 + k, (rows, 4) + coord[:-1]) for k in range(3))
    bits = np.random.default_rng(43).integers(0, 2, size=(rows, 4, 8)).astype(np.int32)
    tp, jp = tuple(map(t, p)), tuple(map(jnp.asarray, p))
    same_pt(msm.tree_sum(ours, tp), jax.jit(lambda x: jmsm.tree_sum(theirs, x))(jp))
    p4 = tuple(c[:, :4] for c in tp)
    same_pt(msm.subset_table4(ours, p4),
            jax.jit(lambda x: jmsm.subset_table4(theirs, x))(tuple(c[:, :4] for c in jp)))
    planes = msm.masked_plane_sums(ours, tp, torch.as_tensor(bits))
    jplanes = jax.jit(lambda x, b: jmsm.masked_plane_sums(theirs, x, b))(jp, jnp.asarray(bits))
    same_pt(planes, jplanes)
    same_pt(msm.horner_pow2(ours, planes), jax.jit(lambda x: jmsm.horner_pow2(theirs, x))(jplanes))
