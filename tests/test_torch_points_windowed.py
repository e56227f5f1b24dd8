"""`CurveOps.to_affine` and `CurveOps.scalar_mul_windowed` of the port
(`ops/points.py`) against the JAX package's `CurveOps` (`ops/points.py:214`
and `:277`) on seeded points, by canonical value: G1 and G2 points of the
oracle (`lodestar_tpu.bls.curve`) given random projective Z (with one
point at infinity), and seeded scalars (G1: 8 bits in two 4-bit windows,
and 6 bits, which take the bit ladder; G2: 4 bits in two 2-bit windows),
each result also held against the oracle's scalar product and the bit
ladder. No path of the port calls either function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.bls.curve import PointG1, PointG2
from lodestar_tpu.bls.fields import Fq, Fq2
from lodestar_tpu.ops import io_host as jio
from lodestar_tpu.ops import points as jpoints
from lodestar_tpu_torch.ops import points

torch.set_num_threads(1)

CURVES = {"g1": (points.g1, jpoints.g1, PointG1, Fq, jio.limbs_to_fq, jio.fq_to_limbs),
          "g2": (points.g2, jpoints.g2, PointG2, Fq2, jio.limbs_to_fq2, jio.fq2_to_limbs)}


def _rand_field(kind, rng):
    Field = CURVES[kind][3]
    ints = [int.from_bytes(rng.bytes(48), "big") for _ in range(2)]
    if kind == "g1":
        return Field(ints[0])
    return Field.from_ints(*ints)


def oracle_points(kind, seed, n):
    rng = np.random.default_rng(seed)
    gen = CURVES[kind][2].generator()
    return [gen * int(rng.integers(1, 2**32)) for _ in range(n)]


def projective(kind, pts, seed):
    """Limbs of each oracle point as (X·Z, Y·Z, Z) with a random Z; the
    last point is infinity (0, 1, 0)."""
    _, _, Point, Field, _, to_limbs = CURVES[kind]
    rng = np.random.default_rng(seed)
    cols = ([], [], [])
    for p in pts:
        x, y = p.to_affine()
        z = _rand_field(kind, rng)
        for c, v in zip(cols, (x * z, y * z, z)):
            c.append(to_limbs(v))
    one = Field(1) if kind == "g1" else Field.from_ints(1, 0)
    zero = Field(0) if kind == "g1" else Field.zero()
    for c, v in zip(cols, (zero, one, zero)):
        c.append(to_limbs(v))
    return tuple(np.stack(c) for c in cols)


def canonical(kind, coords):
    """Canonical field values of an affine (x, y) pair of limb arrays."""
    from_limbs = CURVES[kind][4]
    return [tuple(from_limbs(np.asarray(c)[i]) for c in coords)
            for i in range(np.asarray(coords[0]).shape[0])]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_to_affine_equals_jax(kind):
    ours, theirs = CURVES[kind][:2]
    pts = oracle_points(kind, 3, 3)
    p = projective(kind, pts, 4)
    got = ours.to_affine(tuple(torch.as_tensor(c) for c in p))
    want = jax.jit(theirs.to_affine)(tuple(jnp.asarray(c) for c in p))
    got_vals = canonical(kind, [g.numpy() for g in got])
    assert got_vals == canonical(kind, want)
    assert got_vals[:3] == [pt.to_affine() for pt in pts]
    zero = CURVES[kind][3](0) if kind == "g1" else CURVES[kind][3].zero()
    assert got_vals[3] == (zero, zero)  # infinity maps to (0, 0)


def _bits(scalars, nbits):
    return np.array([[(s >> (nbits - 1 - j)) & 1 for j in range(nbits)] for s in scalars],
                    np.int32)


# G1 at the default 4-bit window; G2 at 2-bit windows, which keeps the JAX
# compile of its table and scan within a few seconds
@pytest.mark.parametrize("kind,nbits,window", [("g1", 8, 4), ("g2", 4, 2), ("g1", 6, 4)])
def test_scalar_mul_windowed_equals_jax(kind, nbits, window):
    ours, theirs, Point, _, _, to_limbs = CURVES[kind]
    pts = oracle_points(kind, 11, 3)
    rng = np.random.default_rng(12)
    scalars = [0, (1 << nbits) - 1, int(rng.integers(1, 1 << nbits))]
    bits = _bits(scalars, nbits)
    xs, ys = zip(*(tuple(to_limbs(c) for c in p.to_affine()) for p in pts))
    q = (np.stack(xs), np.stack(ys))
    got = ours.scalar_mul_windowed(torch.as_tensor(bits), tuple(torch.as_tensor(c) for c in q),
                                   window=window)
    fn = jax.jit(lambda b, qx, qy: theirs.to_affine(
        theirs.scalar_mul_windowed(b, (qx, qy), window=window)))
    want = fn(jnp.asarray(bits), jnp.asarray(q[0]), jnp.asarray(q[1]))
    got_aff = ours.to_affine(got)
    got_vals = canonical(kind, [g.numpy() for g in got_aff])
    assert got_vals == canonical(kind, want)
    inf = ours.is_infinity(got).numpy()
    assert inf.tolist() == [True, False, False]
    for i in (1, 2):
        assert got_vals[i] == (pts[i] * scalars[i]).to_affine()
    # the ladder's result, point for point
    ladder = ours.to_affine(ours.scalar_mul_bits(
        torch.as_tensor(bits), tuple(torch.as_tensor(c) for c in q)))
    assert canonical(kind, [g.numpy() for g in ladder]) == got_vals
