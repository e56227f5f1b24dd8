"""K1's half-warp Montgomery multiply (`csrc/fp_mont_group.cuh`) through
its host build, each product's 16 lanes run as fibers whose shuffles are
emulated (`cuda_fp.mont_mul_group_host`), against the plain version, the
one-thread CIOS it replaced on the card (`csrc/fp_mont.cuh`,
`cuda_fp.mont_mul_host`) and the JAX package.

Tolerance 0 everywhere (integer arithmetic): REDC without a final
subtraction is one integer at any digit width, so every version gives the
same limbs for a, b < 2p:

- with the lanes resumed 0..15 and 15..0, on 200 seeded random pairs below
  2p and on every pair of the edges 0, 1, p − 1, p, 2p − 1 and the
  all-ones value below 2p (2^381 − 1, whose 32-bit words give the largest
  products the redundant accumulator must hold);
- a product count that is not a multiple of the kernel's 8 per block: the
  tail groups run their shuffles and write nothing, and every group makes
  the same 45 exchanges;
- the JAX package's `fp.mul`; slow tier: its Pallas kernel in interpret
  mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import fp as jfp
from lodestar_tpu_torch import build
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_fp
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

ALL_ONES = 2**381 - 1  # the largest value below 2p whose words are all ones
EDGES = [0, 1, P - 1, P, 2 * P - 1, ALL_ONES]


def limbs(vals) -> np.ndarray:
    return np.stack([int_to_limbs(v) for v in vals]).astype(np.int32)


def random_pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    draw = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(2 * n)]
    return limbs(draw[:n]), limbs(draw[n:])


def edge_pairs():
    return limbs([x for x in EDGES for _ in EDGES]), limbs([y for _ in EDGES for y in EDGES])


def plain(a, b) -> np.ndarray:
    return cuda_fp.mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["lanes_0_to_15", "lanes_15_to_0"])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_group_equals_plain_and_the_one_thread_cios(case, reverse):
    a, b = random_pairs(101, 200) if case == "random" else edge_pairs()
    got = cuda_fp.mont_mul_group_host(a, b, reverse=reverse)
    np.testing.assert_array_equal(got, plain(a, b))
    np.testing.assert_array_equal(got, cuda_fp.mont_mul_host(a, b))


def test_all_ones_operands_fit_the_redundant_words():
    """2^381 − 1 squared, and times 2p − 1, p − 1: every a_j b_i is
    (2^32 − 1)^2 or near it, the carry word's worst case."""
    a = limbs([ALL_ONES] * 3)
    b = limbs([ALL_ONES, 2 * P - 1, P - 1])
    want = plain(a, b)
    for reverse in (False, True):
        np.testing.assert_array_equal(cuda_fp.mont_mul_group_host(a, b, reverse=reverse), want)


def test_a_tail_that_is_not_a_multiple_of_eight_products():
    """13 products: the second block's last 3 groups have no product. They
    must make the same exchanges as the others and write nothing (guard
    rows after the output keep their value)."""
    lib = cuda_fp._host()
    a, b = random_pairs(102, 13)
    out = np.full((16, 32), -5, np.int32)
    fn = lib.lodestar_mont_mul_group_host
    for reverse in (0, 1):
        exchanges = fn(a.ctypes.data, b.ctypes.data, out.ctypes.data, 13, reverse)
        assert exchanges == 45
        np.testing.assert_array_equal(out[:13], plain(a, b))
        assert (out[13:] == -5).all()


def test_group_equals_jax_fp_mul():
    a, b = random_pairs(103, 40)
    ref = np.asarray(jfp.mul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(cuda_fp.mont_mul_group_host(a, b), ref)


def test_header_constants_are_shared():
    """The group reads p and N0' from fp_mont.cuh, and K1 builds both headers."""
    with open(f"{build.CSRC}/fp_mont_group.cuh") as f:
        src = f.read()
    assert '#include "fp_mont.cuh"' in src
    assert "kN0 =" not in src and "p[0] =" not in src  # no second copy of p or N0'
    assert build.MONT_MUL_HEADERS == ["fp_mont.cuh", "fp_mont_group.cuh"]


@pytest.mark.slow
def test_group_equals_pallas_interpret():
    from lodestar_tpu.ops import pallas_fp

    a, b = random_pairs(104, 64)
    a = np.concatenate([a, edge_pairs()[0]])
    b = np.concatenate([b, edge_pairs()[1]])
    ref = pallas_fp.mont_mul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(cuda_fp.mont_mul_group_host(a, b), np.asarray(ref))
