"""K4, the Montgomery multiply with its constant products on the integer
tensor cores (`ops/cuda_mxu.py`, `csrc/mxu_mont.cuh`), and the lane rule
of `fp.mul`, on the CPU.

Tolerance 0 everywhere (integer arithmetic). Inputs are random values in
[0, 2p) and the 25 pairs of the edges {0, 1, p−1, p, 2p−1}.

- K4's host build (the kernel's own arithmetic with the MMA emulated in the
  PTX fragment layout) equals the plain version, K1's plain version and the
  JAX package's Pallas kernel in interpret mode (`_mxu_tiles`, tile 8)
  limb for limb, at 1, 15, 16, 17, 63, 64, 65 and 4097 products (partial
  16- and 64-product tiles, and the kernel's 32-product warp tiles
  partial, full and one past) and on the edge pairs; the largest byte
  column of its MMAs stays within 48 · 255²;
- the plain version's constant matrices equal the JAX package's, and the
  kernel's byte Toeplitz matrices give N′'s and p's byte columns;
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
from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

EDGES = [0, 1, P - 1, P, 2 * P - 1]
SIZES = [1, 15, 16, 17, 63, 64, 65, 4097]
BYTE_COLUMN_MAX = 48 * 255 * 255  # the exactness bound of an MMA column


def random_limbs(rng, n: int) -> np.ndarray:
    return np.stack([int_to_limbs(int.from_bytes(rng.bytes(48), "little") % (2 * P))
                     for _ in range(n)])


def edge_pairs():
    return (np.stack([int_to_limbs(x) for x in EDGES for _ in EDGES]),
            np.stack([int_to_limbs(y) for _ in EDGES for y in EDGES]))


def operands(seed: int, n: int):
    """n random pairs in [0, 2p), then the 25 edge pairs."""
    rng = np.random.default_rng(seed)
    ea, eb = edge_pairs()
    return (np.concatenate([random_limbs(rng, n), ea]),
            np.concatenate([random_limbs(rng, n), eb]))


def cases():
    """{name: (a, b)}: random pairs at each of SIZES, and the edge pairs."""
    rng = np.random.default_rng(1)
    out = {str(n): (random_limbs(rng, n), random_limbs(rng, n)) for n in SIZES}
    out["edges"] = edge_pairs()
    return out


@pytest.fixture(scope="module")
def pallas_reference():
    """The JAX kernel in interpret mode over every case at once (one
    compile): {name: limbs}."""
    named = cases()
    a = np.concatenate([x for x, _ in named.values()])
    b = np.concatenate([y for _, y in named.values()])
    pad = (-len(a)) % 8
    ja = jnp.asarray(np.concatenate([a, np.zeros((pad, 32), np.int32)]))
    jb = jnp.asarray(np.concatenate([b, np.zeros((pad, 32), np.int32)]))
    ref = np.asarray(pallas_mxu._mxu_tiles(ja, jb, interpret=True, tile=8))
    out, at = {}, 0
    for name, (x, _) in named.items():
        out[name] = ref[at:at + len(x)]
        at += len(x)
    return named, out


@pytest.mark.parametrize("case", [str(n) for n in SIZES] + ["edges"])
def test_host_build_matches_plain_k1_and_the_pallas_interpreter(case, pallas_reference):
    named, ref = pallas_reference
    a, b = named[case]
    got, col_max = cuda_mxu.mont_mul_mxu_host(a, b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_array_equal(got, cuda_mxu.mont_mul_mxu_plain(ta, tb).numpy())
    np.testing.assert_array_equal(got, cuda_fp.mont_mul_plain(ta, tb).numpy())
    np.testing.assert_array_equal(got, ref[case])
    assert 0 < col_max <= BYTE_COLUMN_MAX


def test_constant_matrices_equal_the_jax_ones():
    for name in ("_S_MAT", "_TN", "_TP", "_NPRIME_LIMBS"):
        np.testing.assert_array_equal(getattr(cuda_mxu, name), getattr(pallas_mxu, name),
                                      err_msg=name)
    assert cuda_mxu.MIN_LANES == pallas_mxu.MIN_LANES
    # the kernel's byte Toeplitz matrices: column c of x·T is byte column c
    # of x times N′ (mod R) or p, for the 48 bytes of x
    nprime = sum(int(v) << (12 * i) for i, v in enumerate(pallas_mxu._NPRIME_LIMBS))
    assert (P * nprime + 1) % R_MONT == 0
    x = np.random.default_rng(5).integers(0, 256, 48)
    value = sum(int(v) << (8 * i) for i, v in enumerate(x))
    for table, const, cols in ((cuda_mxu.TN8, nprime, 48), (cuda_mxu.TP8, P, 96)):
        assert table.shape == (cols, 64) and table.dtype == np.uint8
        assert not table[:, 48:].any()
        col = table[:, :48].astype(np.int64) @ x
        assert sum(int(c) << (8 * i) for i, c in enumerate(col)) % 2 ** (8 * cols) \
            == value * const % 2 ** (8 * cols)


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


PTXAS_K4 = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15mxu_mont_kernelILi4EEvPKiS1_PKjPix' for 'sm_90a'
ptxas info    : Function properties for _Z15mxu_mont_kernelILi4EEvPKiS1_PKjPix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers, 46080 bytes smem
ptxas info    : Compile time = 106.922 ms
"""


def test_ptxas_summary_reads_registers_shared_memory_and_spills():
    from lodestar_tpu_torch import build

    assert build.ptxas_summary(PTXAS_K4) == {"_Z15mxu_mont_kernelILi4EEvPKiS1_PKjPix": {
        "entry": 1, "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 106,
        "smem": 46080}}
