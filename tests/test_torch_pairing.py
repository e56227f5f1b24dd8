"""The port's pairing (`lodestar_tpu_torch.ops.pairing`).

- `miller_loop_proj_pq` at 2 lanes, limb for limb against the JAX
  package's `lodestar_tpu.ops.pairing.miller_loop_proj_pq` (tolerance 0).
- `final_exponentiation_one` / `_batch` by canonical value against the
  CPU oracle `lodestar_tpu.bls.pairing.final_exponentiation` on 1–2 lanes;
  the limb-exact comparison against the JAX batch compiles the whole hard
  part and sits in the slow tier.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.bls import pairing as oracle
from lodestar_tpu.bls.fields import Fq, Fq2, Fq6, Fq12
from lodestar_tpu.ops import io_host as jio
from lodestar_tpu.ops import pairing as jpairing
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import pairing
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)


def rand(seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(n)]
    return np.stack([int_to_limbs(v) for v in vals]).reshape(tuple(shape) + (32,))


def t(x):
    return torch.as_tensor(np.array(x))


def test_miller_loop_proj_pq_two_lanes():
    p = (rand(1, (2,)), rand(2, (2,)), rand(3, (2,)))
    q = (rand(4, (2, 2)), rand(5, (2, 2)), rand(6, (2, 2)))
    got = pairing.miller_loop_proj_pq(tuple(map(t, p)), tuple(map(t, q)))
    ref = jax.jit(jpairing.miller_loop_proj_pq)(
        tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q))
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.slow
def test_miller_loop_affine_two_lanes():
    """The affine-Q line (`_line_and_add`), off the grouped path."""
    xp, yp, xq, yq = rand(7, (2,)), rand(8, (2,)), rand(9, (2, 2)), rand(10, (2, 2))
    got = pairing._miller_loop_impl(t(xp), t(yp), None, t(xq), t(yq), None)
    ref = jax.jit(lambda a, b, c, d: jpairing._miller_loop_impl(a, b, None, c, d, None))(
        jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(xq), jnp.asarray(yq)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def rand_fq12(rng):
    def fq2():
        return Fq2(Fq(rng.randrange(P)), Fq(rng.randrange(P)))

    return Fq12(Fq6(fq2(), fq2(), fq2()), Fq6(fq2(), fq2(), fq2()))


def test_final_exponentiation_one_by_value():
    f = rand_fq12(random.Random(7))
    got = pairing.final_exponentiation_one(t(jio.fq12_to_limbs(f)))
    assert jio.limbs_to_fq12(got.numpy()) == oracle.final_exponentiation(f)


def test_final_exponentiation_batch_by_value_with_a_zero_lane():
    rng = random.Random(8)
    fs = [rand_fq12(rng), Fq12.zero()]
    got = pairing.final_exponentiation_batch(t(np.stack([jio.fq12_to_limbs(f) for f in fs])))
    assert jio.limbs_to_fq12(got[0].numpy()) == oracle.final_exponentiation(fs[0])
    # the zero-lane guard: 0 stays 0 through the easy part, as per lane
    assert jio.limbs_to_fq12(got[1].numpy()) == Fq12.zero()


@pytest.mark.slow
def test_final_exponentiation_batch_limb_exact():
    fs = rand(9, (3, 2, 3, 2))
    fs[1] = 0
    got = pairing.final_exponentiation_batch(t(fs))
    ref = jax.jit(jpairing.final_exponentiation_batch)(jnp.asarray(fs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
