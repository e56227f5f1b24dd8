"""The port's tower (`lodestar_tpu_torch.ops.fp2/fp6/fp12`) against the JAX
package's `lodestar_tpu.ops.fp2/fp6/fp12`, limb for limb (tolerance 0).

Inputs are random limb vectors in [0, 2p) made from a seed with numpy, so
both the canonical and the lazy representatives are exercised; the same
arrays go through both packages. Fp2 runs on both sides of the lazy gate:
the JAX package is switched with LODESTAR_TPU_LAZY_FP2=0 and the port
with its LAZY_MAX_ELEMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import fp2 as jfp2
from lodestar_tpu.ops import fp6 as jfp6
from lodestar_tpu.ops import fp12 as jfp12
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import fp2, fp6, fp12
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


def same(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lazy", [True, False])
def test_fp2_mul_square_both_sides_of_the_lazy_gate(lazy, monkeypatch):
    if not lazy:
        monkeypatch.setenv("LODESTAR_TPU_LAZY_FP2", "0")
        monkeypatch.setattr(fp2, "LAZY_MAX_ELEMS", -1)
    a, b = rand(1, (6, 2)), rand(2, (6, 2))
    # fresh wrappers: the JAX gate is read when a function is traced
    jmul = jax.jit(lambda x, y: jfp2.mul(x, y))
    same(fp2.mul(t(a), t(b)), jmul(jnp.asarray(a), jnp.asarray(b)))
    same(fp2.square(t(a)), jax.jit(lambda x: jfp2.square(x))(jnp.asarray(a)))
    # broadcasting a scalar operand
    same(fp2.mul(t(a), t(b[0])), jmul(jnp.asarray(a), jnp.asarray(b[0])))


def test_fp2_small_ops():
    a = rand(3, (5, 2))
    for name in ("mul_by_xi", "conj", "inv"):
        same(getattr(fp2, name)(t(a)), jax.jit(getattr(jfp2, name))(jnp.asarray(a)))
    k = rand(4, (5,))
    same(fp2.mul_fp(t(a), t(k)), jax.jit(jfp2.mul_fp)(jnp.asarray(a), jnp.asarray(k)))


@pytest.mark.parametrize("name", ["mul", "square", "inv"])
def test_fp6(name):
    a, b = rand(5, (3, 3, 2)), rand(6, (3, 3, 2))
    args = (a, b) if name == "mul" else (a,)
    fn = jax.jit(getattr(jfp6, name))
    same(getattr(fp6, name)(*map(t, args)), fn(*map(jnp.asarray, args)))


@pytest.mark.parametrize("name", ["mul", "square", "cyclotomic_square", "conj"])
def test_fp12_products(name):
    a, b = rand(7, (2, 2, 3, 2)), rand(8, (2, 2, 3, 2))
    args = (a, b) if name == "mul" else (a,)
    fn = jax.jit(getattr(jfp12, name))
    same(getattr(fp12, name)(*map(t, args)), fn(*map(jnp.asarray, args)))


def test_fp12_inv():
    a = rand(9, (2, 2, 3, 2))
    same(fp12.inv(t(a)), jax.jit(jfp12.inv)(jnp.asarray(a)))


def test_fp12_batch_inv_with_a_zero_lane():
    a = rand(10, (5, 2, 3, 2))
    a[2] = 0
    same(fp12.batch_inv(t(a)), jax.jit(jfp12.batch_inv)(jnp.asarray(a)))


@pytest.mark.parametrize("power", [1, 2, 3])
def test_fp12_frobenius(power):
    a = rand(11 + power, (2, 2, 3, 2))
    ref = jax.jit(jfp12.frobenius, static_argnums=1)(jnp.asarray(a), power)
    same(fp12.frobenius(t(a), power), ref)


def test_fp12_mul_by_line():
    f = rand(20, (3, 2, 3, 2))
    l0, l1, l2 = rand(21, (3, 2)), rand(22, (3, 2)), rand(23, (3, 2))
    args = (f, l0, l1, l2)
    same(fp12.mul_by_line(*map(t, args)), jax.jit(jfp12.mul_by_line)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("n", [1, 5])
def test_fp12_product_tree(n):
    fs = rand(30 + n, (n, 2, 3, 2))
    same(fp12.product_tree(t(fs)), jax.jit(jfp12.product_tree)(jnp.asarray(fs)))


def test_fp12_is_one():
    one = np.array(jfp12.one((3,)))
    one[1, 0, 0, 0] = int_to_limbs(P + int(sum(int(v) << (12 * i) for i, v in enumerate(one[1, 0, 0, 0]))))
    one[2, 1, 0, 0, 0] = 1
    got = fp12.is_one(t(one)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfp12.is_one(jnp.asarray(one))))
    assert got.tolist() == [True, True, False]
