"""The port's base field (`lodestar_tpu_torch.ops.fp`, `ops.cuda_fp`)
against the JAX package's `lodestar_tpu.ops.fp`, limb for limb.

The same inputs, made from a seed with numpy, go through both; the
tolerance is zero. The K1 arithmetic header (`csrc/fp_mont.cuh`) is also
built for the host with a C++ compiler and held against the plain
version, which catches an arithmetic fault before the kernel reaches a
GPU.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import fp as jfp
from lodestar_tpu_torch import build
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import cuda_fp, fp
from lodestar_tpu_torch.ops.limbs import int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

EDGES = [0, 1, P - 1, P, 2 * P - 1]


def rand_limbs(rng, n, bound=2 * P):
    vals = [int.from_bytes(rng.bytes(48), "little") % bound for _ in range(n)]
    return np.stack([int_to_limbs(v) for v in vals])


def operands(seed=1, n=24):
    rng = np.random.default_rng(seed)
    edges = np.stack([int_to_limbs(v) for v in EDGES])
    a = np.concatenate([rand_limbs(rng, n), edges, edges])
    b = np.concatenate([rand_limbs(rng, n), edges, edges[::-1]])
    return a, b


def j(x):
    return np.asarray(x)


def t(x):
    return torch.as_tensor(np.array(x))


def test_plain_mont_mul_matches_mul_scan_and_mul():
    a, b = operands()
    got = cuda_fp.mont_mul_plain(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, j(jfp._mul_scan(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, j(jfp.mul(jnp.asarray(a), jnp.asarray(b))))


def test_mul_broadcasts_like_jax_and_stays_off_the_kernel_on_cpu():
    a, b = operands(seed=2, n=6)
    a3 = a[:6].reshape(2, 3, 32)
    before = cuda_fp.LAUNCHES
    got = fp.mul(t(a3), t(b[:3])).numpy()
    np.testing.assert_array_equal(got, j(jfp.mul(jnp.asarray(a3), jnp.asarray(b[:3]))))
    assert got.shape == (2, 3, 32)
    assert cuda_fp.LAUNCHES == before  # CPU tensors take the plain version


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = operands(seed=3, n=2)
    with pytest.raises(ValueError):
        cuda_fp.mont_mul_cuda(t(a), t(b))


@pytest.mark.parametrize("name", ["add", "sub"])
def test_add_sub(name):
    a, b = operands(seed=4)
    got = getattr(fp, name)(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, j(getattr(jfp, name)(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("name", ["neg", "double", "canonical"])
def test_unary(name):
    a, _ = operands(seed=5)
    got = getattr(fp, name)(t(a)).numpy()
    np.testing.assert_array_equal(got, j(getattr(jfp, name)(jnp.asarray(a))))


def test_eq_and_is_zero():
    a, b = operands(seed=6)
    # b2 is a's other representative where one exists (a + p < 2p)
    b2 = np.stack([int_to_limbs((fp_int(x) + P) % (2 * P)) for x in a])
    for x, y in ((a, b), (a, b2), (a, a)):
        np.testing.assert_array_equal(
            fp.eq(t(x), t(y)).numpy(), j(jfp.eq(jnp.asarray(x), jnp.asarray(y)))
        )
    np.testing.assert_array_equal(fp.is_zero(t(a)).numpy(), j(jfp.is_zero(jnp.asarray(a))))


def fp_int(limbs):
    return sum(int(v) << (12 * i) for i, v in enumerate(limbs))


@pytest.mark.parametrize("cols", [32, 64, 16])
def test_carry_scan_signed_columns(cols):
    rng = np.random.default_rng(cols)
    cases = [
        rng.integers(-(2**30), 2**30, size=(40, cols)),
        rng.integers(-3, 4100, size=(200, cols)),
        rng.choice(np.array([-1, 0, 1, 4095, 4096]), size=(400, cols)),
    ]
    for x in cases:
        x = x.astype(np.int32)
        limbs, out = fp._carry_scan_out(t(x))
        jl, jo = jfp._carry_scan_out(jnp.asarray(x))
        np.testing.assert_array_equal(limbs.numpy(), j(jl))
        np.testing.assert_array_equal(out.numpy(), j(jo))
        np.testing.assert_array_equal(fp.carry_scan(t(x)).numpy(), j(jfp.carry_scan(jnp.asarray(x))))


def test_lex_ge():
    a, b = operands(seed=7)
    ca, cb = jfp.canonical(jnp.asarray(a)), jfp.canonical(jnp.asarray(b))
    np.testing.assert_array_equal(
        fp._lex_ge(t(j(ca)), t(j(cb))).numpy(), j(jfp._lex_ge(ca, cb))
    )


def test_reduce_sums():
    a, b = operands(seed=8)
    tp = fp.two_p(t(a)).numpy()
    stack = np.stack([a + b, a - b + tp])
    np.testing.assert_array_equal(
        fp.reduce_sums(t(stack)).numpy(), j(jfp.reduce_sums(jnp.asarray(stack)))
    )


def test_reduce_stack_mixed_bounds():
    a, b = operands(seed=9)
    c, _ = operands(seed=10)

    def exprs(F, W, A, B, C):
        return [
            W(A) + W(B),
            W(A) - W(B) - W(C),
            W(A).double().double() + W(C) - W(B).double(),
            W(C) - (W(A).double() + W(A)),
            W(B),
        ]

    got = fp.reduce_stack(exprs(fp, fp.wrap, t(a), t(b), t(c)))
    ref = jfp.reduce_stack(exprs(jfp, jfp.wrap, *(jnp.asarray(x) for x in (a, b, c))))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), j(r))


def test_conv_cols_and_redc_cols_on_signed_columns():
    a, b = operands(seed=11)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(fp.conv_cols(t(a), t(b)).numpy(), j(jfp.conv_cols(ja, jb)))
    # the lazy Fp2 combines: p0 − p1 + 4p² and p2 − p0 − p1 + 8p²
    s_a, s_b = jfp.add(ja, jb), jfp.add(jb, ja)
    p0, p1, p2 = jfp.conv_cols(ja, jb), jfp.conv_cols(jb, jb), jfp.conv_cols(s_a, s_b)
    for cols in (p0 - p1 + jfp.FOUR_P2_COLS, p2 - p0 - p1 + jfp.EIGHT_P2_COLS):
        cols = j(cols)
        assert cols.min() < 0  # signed columns
        np.testing.assert_array_equal(fp.redc_cols(t(cols)).numpy(), j(jfp.redc_cols(jnp.asarray(cols))))


def test_to_from_mont():
    a, _ = operands(seed=12)
    c = j(jfp.canonical(jnp.asarray(a)))
    np.testing.assert_array_equal(fp.to_mont(t(c)).numpy(), j(jfp.to_mont(jnp.asarray(c))))
    np.testing.assert_array_equal(fp.from_mont(t(a)).numpy(), j(jfp.from_mont(jnp.asarray(a))))


@pytest.mark.parametrize("name", ["inv", "sqrt_candidate"])
def test_power_chains(name):
    a, _ = operands(seed=13, n=3)
    a = a[[0, 1, 3, 4, 5, 6, 7]]  # random values, 0, 1, p−1, p
    got = getattr(fp, name)(t(a)).numpy()
    np.testing.assert_array_equal(got, j(jax.jit(getattr(jfp, name))(jnp.asarray(a))))


def test_select():
    a, b = operands(seed=14)
    cond = np.arange(len(a)) % 3 == 0
    np.testing.assert_array_equal(
        fp.select(torch.as_tensor(cond), t(a), t(b)).numpy(),
        j(jfp.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b))),
    )


def test_kernel_header_constants():
    """p and N0' = −p⁻¹ mod 2^32 as written into csrc/fp_mont.cuh."""
    with open(f"{build.CSRC}/fp_mont.cuh") as f:
        src = f.read()
    words = [int(w, 16) for w in re.findall(r"p\[\d+\] = (0x[0-9a-f]+)u;", src)]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P
    n0 = int(re.search(r"kN0 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert (n0 * P) % 2**32 == 2**32 - 1


def test_kernel_arithmetic_host_build_matches_plain():
    """csrc/fp_mont.cuh, compiled for the host, against the plain version."""
    if build.find_compiler("c++", "g++", "clang++") is None:
        pytest.skip("no C++ compiler to build the host harness of fp_mont.cuh")
    lib = build.mont_mul_host()
    fn = lib.lodestar_mont_mul_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    rng = np.random.default_rng(15)
    a, b = operands(seed=15, n=500)
    a = np.concatenate([a, rand_limbs(rng, 200, bound=2**381)])
    b = np.concatenate([b, rand_limbs(rng, 200, bound=2 * P)])
    a, b = np.ascontiguousarray(a, np.int32), np.ascontiguousarray(b, np.int32)
    out = np.zeros_like(a)
    fn(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a))
    np.testing.assert_array_equal(out, cuda_fp.mont_mul_plain(t(a), t(b)).numpy())


@pytest.mark.slow
def test_plain_mont_mul_matches_pallas_interpret():
    from lodestar_tpu.ops import pallas_fp

    a, b = operands(seed=16, n=100)
    got = cuda_fp.mont_mul_plain(t(a), t(b)).numpy()
    ref = pallas_fp.mont_mul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(got, j(ref))
