"""K2, the affine Miller loop, on K2p's warp program at unit Z
(`tower.cu` `miller_warp_kernel` over `csrc/miller_warp.cuh`
`miller_warp`), through its host build with the warp emulated one thread
after another (`cuda_tower.miller_loop_warp_host`).

Tolerance 0 everywhere (integer arithmetic). The lanes are valid G1 and G2
points (the generators doubled a number of times drawn from a numpy seed)
in Montgomery form, once with canonical coordinates and once with every
coordinate in [p, 2p), plus one all-zero lane:

- the threads of every phase run 0..31 and 31..0 agree limb for limb (the
  slot buffer starts from a different pattern in each order, so a slot
  read before it is written shows as a difference);
- both equal, limb for limb, the one-thread affine lane that the kernel
  replaced (`tower.cuh` `miller_lane`, `miller_loop_host`), and the
  canonical value of the JAX package's
  `pallas_tower.miller_loop_pallas(..., interpret=True)` on 3 lanes;
- the all-zero lane gives f = 0, as the Pallas kernel does;
- the bound's count is the schedule's 8,182 Fp multiplies, fewer than the
  one-thread lane's 8,282;
- no CUDA source of the port raises a device limit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import pallas_tower
from lodestar_tpu_torch.bls.curve import PointG1, PointG2
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_tower, fp
from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(cuda_tower.__file__), "..", "csrc")
R = R_MONT % P
VALID = 2  # valid lanes; each comes canonical and in [p, 2p)


def canon(x) -> np.ndarray:
    return fp.canonical(torch.as_tensor(np.array(x))).numpy()


def mont(v: int, high: bool) -> np.ndarray:
    """The Montgomery form of v as limbs, in [0, p) or (`high`) [p, 2p)."""
    return int_to_limbs(v * R % P + (P if high else 0))


def _doubled(point, k: int):
    for _ in range(k):
        point = point.double()
    return point.to_affine()


def affine_lanes(seed: int):
    """The VALID lanes with canonical coordinates, the same lanes with every
    coordinate in [p, 2p), then one all-zero lane: (xp, yp, xq, yq)."""
    rng = np.random.default_rng(seed)
    pts = [(_doubled(PointG1.generator(), int(rng.integers(1, 40))),
            _doubled(PointG2.generator(), int(rng.integers(1, 40)))) for _ in range(VALID)]
    cols = ([], [], [], [])
    for high in (False, True):
        for (gx, gy), (qx, qy) in pts:
            cols[0].append(mont(gx.n, high))
            cols[1].append(mont(gy.n, high))
            cols[2].append(np.stack([mont(qx.c0.n, high), mont(qx.c1.n, high)]))
            cols[3].append(np.stack([mont(qy.c0.n, high), mont(qy.c1.n, high)]))
    for c in cols:
        c.append(np.zeros_like(c[0]))
    return tuple(np.stack(c).astype(np.int32) for c in cols)


@pytest.fixture(scope="module")
def lanes_and_warp():
    lanes = affine_lanes(91)
    fwd = cuda_tower.miller_loop_warp_host(*lanes)
    rev = cuda_tower.miller_loop_warp_host(*lanes, reverse=True)
    return lanes, fwd, rev


def test_lanes_cover_both_coordinate_ranges(lanes_and_warp):
    (xp, _, xq, _), _, _ = lanes_and_warp
    p_limbs = int_to_limbs(P)
    below = [bool(tuple(a[::-1]) < tuple(p_limbs[::-1])) for a in xp[:-1]]
    assert below == [True] * VALID + [False] * VALID
    assert (xq[-1] == 0).all()


def test_warp_orders_agree_limb_for_limb(lanes_and_warp):
    _, fwd, rev = lanes_and_warp
    assert fwd.shape == (2 * VALID + 1, 2, 3, 2, 32)
    np.testing.assert_array_equal(fwd, rev)


def test_warp_equals_the_one_thread_lane(lanes_and_warp):
    lanes, fwd, _ = lanes_and_warp
    np.testing.assert_array_equal(fwd, cuda_tower.miller_loop_host(*lanes))
    # canonical limbs, and the same value from either coordinate range
    assert (fwd >= 0).all() and (fwd < 4096).all()
    np.testing.assert_array_equal(fwd[:VALID], fwd[VALID:2 * VALID])


def test_zero_lane_gives_zero(lanes_and_warp):
    _, fwd, _ = lanes_and_warp
    assert (fwd[-1] == 0).all()
    assert (fwd[:-1] != 0).any(axis=(1, 2, 3, 4)).all()


def test_warp_equals_jax_interpret_three_lanes(lanes_and_warp):
    """A canonical lane, a lane in [p, 2p) and the zero lane through the
    JAX package's Pallas kernel in interpret mode."""
    lanes, fwd, _ = lanes_and_warp
    pick = [0, VALID + 1, 2 * VALID]
    xp, yp, xq, yq = (c[pick] for c in lanes)
    ref = pallas_tower.miller_loop_pallas(
        (jnp.asarray(xp), jnp.asarray(yp)), (jnp.asarray(xq), jnp.asarray(yq)), interpret=True)
    np.testing.assert_array_equal(fwd[pick], canon(np.asarray(ref)))


def test_bound_counts_the_schedule_at_unit_z():
    muls = cuda_tower.fp_muls_per_lane()
    assert muls["miller_loop"] == 8282
    assert muls["miller_loop_warp"] == muls["miller_loop_proj_warp"] == 8182
    assert muls["miller_loop_fewest"] == 8182
    assert muls["miller_loop_warp_rounds"] == muls["miller_loop_proj_warp_rounds"]


def test_no_source_raises_a_device_limit():
    sources = [f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh", ".cpp"))]
    assert "tower.cu" in sources
    for name in sources:
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        assert "cudaDeviceSetLimit" not in text, name
        assert "ensure_stack" not in text, name
