"""K4, the Montgomery multiply on the integer tensor cores (`ops/cuda_mxu.py`,
`csrc/mxu_mont.cuh`), and the lane rule of `fp.mul`, on the CPU.

Tolerance 0 everywhere (integer arithmetic). Inputs are 64 random values in
[0, 2p) and the 25 pairs of the edges {0, 1, p−1, p, 2p−1}.

- K4's host build (the kernel's own arithmetic with the MMA emulated in the
  PTX fragment layout) equals the plain version, K1's plain version and the
  JAX package's Pallas kernel in interpret mode (`_mxu_tiles`, tile 8)
  limb for limb, on a count of products that leaves a partial warp tile;
  the largest column of its t, m and t + u carries stays below 2^30;
- the port's constant matrices equal the JAX package's;
- `fp.mul` takes K1's route at 4095 products and K4's at 4096, with the
  same limbs (spies on the two plain versions);
- the CUDA wrapper refuses CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import pallas_mxu
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu, fp
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

EDGES = [0, 1, P - 1, P, 2 * P - 1]


def operands(seed: int, n: int):
    """n random pairs in [0, 2p), then the 25 edge pairs."""
    rng = np.random.default_rng(seed)

    def rand(k):
        return np.stack([int_to_limbs(int.from_bytes(rng.bytes(48), "little") % (2 * P))
                         for _ in range(k)])

    ea = np.stack([int_to_limbs(x) for x in EDGES for _ in EDGES])
    eb = np.stack([int_to_limbs(y) for _ in EDGES for y in EDGES])
    return np.concatenate([rand(n), ea]), np.concatenate([rand(n), eb])


def test_host_build_matches_plain_k1_and_the_pallas_interpreter():
    a, b = operands(1, 64)  # 89 products: five full warp tiles and a partial one
    got, col_max = cuda_mxu.mont_mul_mxu_host(a, b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_array_equal(got, cuda_mxu.mont_mul_mxu_plain(ta, tb).numpy())
    np.testing.assert_array_equal(got, cuda_fp.mont_mul_plain(ta, tb).numpy())
    pad = (-len(a)) % 8
    ja = jnp.asarray(np.concatenate([a, np.zeros((pad, 32), np.int32)]))
    jb = jnp.asarray(np.concatenate([b, np.zeros((pad, 32), np.int32)]))
    ref = np.asarray(pallas_mxu._mxu_tiles(ja, jb, interpret=True, tile=8))[: len(a)]
    np.testing.assert_array_equal(got, ref)
    assert 0 < col_max < 2**30


def test_constant_matrices_equal_the_jax_ones():
    for name in ("_S_MAT", "_TN", "_TP", "_NPRIME_LIMBS"):
        np.testing.assert_array_equal(getattr(cuda_mxu, name), getattr(pallas_mxu, name),
                                      err_msg=name)
    np.testing.assert_array_equal(cuda_mxu.TNT, pallas_mxu._TN.T.astype(np.uint8))
    np.testing.assert_array_equal(cuda_mxu.TPT, pallas_mxu._TP.T.astype(np.uint8))
    assert cuda_mxu.MIN_LANES == pallas_mxu.MIN_LANES


@pytest.mark.parametrize("n, route", [(4095, "k1"), (4096, "k4")])
def test_lane_rule(monkeypatch, n, route):
    a, b = operands(2, 16)
    reps = -(-n // len(a))
    ta = torch.as_tensor(np.tile(a, (reps, 1))[:n])
    tb = torch.as_tensor(np.tile(b, (reps, 1))[:n])
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cuda_fp, "mont_mul_plain", spy("k1", cuda_fp.mont_mul_plain))
    monkeypatch.setattr(cuda_mxu, "mont_mul_mxu_plain", spy("k4", cuda_mxu.mont_mul_mxu_plain))
    got = fp.mul(ta, tb).numpy()
    assert calls == [route]
    monkeypatch.undo()
    np.testing.assert_array_equal(got, cuda_fp.mont_mul_plain(ta, tb).numpy())
    # broadcasting counts the flattened products, as the JAX rule does
    calls.clear()
    monkeypatch.setattr(cuda_mxu, "mont_mul_mxu_plain", spy("k4", cuda_mxu.mont_mul_mxu_plain))
    monkeypatch.setattr(cuda_fp, "mont_mul_plain", spy("k1", cuda_fp.mont_mul_plain))
    wide = fp.mul(ta[:1].expand(n, 32), tb[:1])
    assert calls == [route] and wide.shape == (n, 32)


def test_cuda_wrapper_refuses_cpu_tensors():
    a, b = operands(3, 4)
    with pytest.raises(ValueError):
        cuda_mxu.mont_mul_mxu_cuda(torch.as_tensor(a), torch.as_tensor(b))
