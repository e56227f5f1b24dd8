"""K4, the Montgomery multiply on the integer tensor cores: the CUDA kernel,
its plain version, and the lane rule of `fp.mul`.

`mont_mul_mxu_cuda` launches the hand-written sm_90a kernel of
`csrc/mxu_mont.cu` (built at first use by `build.mxu_cuda`), which replaces
the JAX package's Pallas kernel `ops/pallas_mxu.py::_mxu_kernel`. It
computes REDC(a·b) as the TPU kernel does: the outer products a_i·b_j split
into three byte parts and contracted with the 0/1 column-select matrix S
(1024 × 64), m = (t mod R)·N′ mod R and u = m·p as products of two byte
parts with the Toeplitz matrices of N′ and p, and carries. The result is
limb for limb K1's (`cuda_fp`) and the word-serial REDC's.

`mont_mul_mxu_plain` is the same three contractions in plain PyTorch
matrix products, with the JAX kernel's carries. The products run in
float64, where every sum is an integer below 2^27 and so exact (CUDA has no
integer matrix product in PyTorch). `mont_mul_mxu_host` runs the kernel's
own arithmetic (`csrc/mxu_mont.cuh`, the MMA emulated) on the CPU.

`mont_mul` is the JAX package's MXU configuration (`LODESTAR_TPU_PALLAS_MXU=1`)
as a fixed rule: a call of fewer than `MIN_LANES` flattened products gives
way to `cuda_fp.mont_mul` (K1, limb for limb the scan the TPU path falls
back to), a larger one takes K4 on CUDA tensors and the plain version on
CPU tensors. `LAUNCHES` counts K4's kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..bls.fields import P as _P_INT
from . import cuda_fp, fp
from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS, P_LIMBS, R_MONT, int_to_limbs

LAUNCHES = 0
# below this many products a call takes K1 (the JAX package's default
# break-even, without its LODESTAR_TPU_PALLAS_MIN_LANES override)
MIN_LANES = 4096
_PLAIN_CHUNK = 1 << 16  # rows per plain-version pass (bounds its memory)

_NPRIME_LIMBS = int_to_limbs((-pow(_P_INT, -1, R_MONT)) % R_MONT)


def _conv_select() -> np.ndarray:
    """(N², 2N) 0/1: flattened outer index (i, j) → column i + j."""
    s = np.zeros((N_LIMBS * N_LIMBS, 2 * N_LIMBS), np.int32)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            s[i * N_LIMBS + j, i + j] = 1
    return s


def _toeplitz(vec: np.ndarray, out_cols: int) -> np.ndarray:
    """(N, out_cols) with T[i, k] = vec[k − i]: (x @ T)[k] = Σ_i x_i·vec_{k−i}."""
    t = np.zeros((N_LIMBS, out_cols), np.int32)
    for i in range(N_LIMBS):
        for k in range(out_cols):
            if 0 <= k - i < N_LIMBS:
                t[i, k] = vec[k - i]
    return t


_S_MAT = _conv_select()
# [lo | hi] byte parts side by side: one product gives both convolutions
_TN = np.concatenate(
    [_toeplitz(_NPRIME_LIMBS & 0xFF, N_LIMBS), _toeplitz(_NPRIME_LIMBS >> 8, N_LIMBS)], axis=1
)  # (32, 64)
_TP = np.concatenate(
    [_toeplitz(P_LIMBS & 0xFF, 2 * N_LIMBS), _toeplitz(P_LIMBS >> 8, 2 * N_LIMBS)], axis=1
)  # (32, 128)
# the kernel reads them transposed, one row of 32 bytes per column
TNT = np.ascontiguousarray(_TN.T, np.uint8)  # (64, 32)
TPT = np.ascontiguousarray(_TP.T, np.uint8)  # (128, 32)
# the plain version's float64 copies (module-level: `fp.const` caches by id)
_S_F64, _TN_F64, _TP_F64 = (m.astype(np.float64) for m in (_S_MAT, _TN, _TP))


# --- the plain version --------------------------------------------------------

def _shift_lanes(x: torch.Tensor, right: int) -> torch.Tensor:
    """Shift along the last axis toward higher indices, zero fill."""
    return torch.nn.functional.pad(x, (right, 0))[:, : x.shape[1]]


def _carry_lanes(cols: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's carry: non-negative columns (< 2^30) → 12-bit
    digits of the value mod 2^(12K). Three shift-folds bring the digits
    to [0, 2^12]; the residual +1 chain resolves with a generate/propagate
    Kogge–Stone prefix."""
    k = cols.shape[1]

    def fold(x):
        return (x & LIMB_MASK) + _shift_lanes(x >> LIMB_BITS, 1)

    v = fold(fold(fold(cols)))
    g = v > LIMB_MASK
    p = v == LIMB_MASK
    shift = 1
    while shift < k:
        g = g | (p & _shift_lanes(g, shift))
        p = p & _shift_lanes(p, shift)
        shift *= 2
    return (v + _shift_lanes(g.to(v.dtype), 1)) & LIMB_MASK


def _parts_matmul(parts: list[torch.Tensor], mat: np.ndarray) -> list[torch.Tensor]:
    """Each byte-part matrix times a constant float64 matrix, as one stacked
    product (exact: integer sums < 2^27) → int64."""
    out = torch.cat(parts, 0).double() @ fp.const(mat, parts[0].device)
    return list(out.long().split(parts[0].shape[0], 0))


def _mont_mul_mxu_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = N_LIMBS
    outer = (a[:, :, None].long() * b[:, None, :].long()).reshape(a.shape[0], n * n)
    lo, mid, hi = _parts_matmul([outer & 0xFF, (outer >> 8) & 0xFF, outer >> 16], _S_F64)
    t_cols = lo + mid * 256 + hi * 65536
    t = _carry_lanes(t_cols)
    tl = t[:, :n]
    t0, t1 = _parts_matmul([tl & 0xFF, tl >> 8], _TN_F64)
    m = _carry_lanes(t0[:, :n] + (t0[:, n:] + t1[:, :n]) * 256 + t1[:, n:] * 65536)
    m0, m1 = _parts_matmul([m & 0xFF, m >> 8], _TP_F64)
    u_cols = m0[:, : 2 * n] + (m0[:, 2 * n:] + m1[:, : 2 * n]) * 256 + m1[:, 2 * n:] * 65536
    return _carry_lanes(t_cols + u_cols)[:, n:].to(torch.int32)


def mont_mul_mxu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a·b) for same-shape (..., 32) int32 limbs, through the
    contractions K4 runs, in passes of at most `_PLAIN_CHUNK` products."""
    shape = a.shape
    a = a.reshape(-1, N_LIMBS)
    b = b.reshape(-1, N_LIMBS)
    out = [_mont_mul_mxu_rows(a[i:i + _PLAIN_CHUNK], b[i:i + _PLAIN_CHUNK])
           for i in range(0, a.shape[0], _PLAIN_CHUNK)]
    if not out:
        return torch.empty(shape, dtype=torch.int32, device=a.device)
    return torch.cat(out, 0).reshape(shape)


# --- the kernel -----------------------------------------------------------------

def _kernel():
    from ..build import mxu_cuda

    fn = mxu_cuda().lodestar_mxu_mont
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mont_mul_mxu_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K4 on same-shape contiguous int32 (..., 32) CUDA tensors."""
    global LAUNCHES
    for x in (a, b):
        if not x.is_cuda:
            raise ValueError("mont_mul_mxu_cuda takes CUDA tensors")
        if x.dtype != torch.int32:
            raise TypeError(f"mont_mul_mxu takes int32 limbs, got {x.dtype}")
        if x.shape[-1:] != (N_LIMBS,) or not x.is_contiguous():
            raise ValueError("mont_mul_mxu takes contiguous (..., 32) limbs")
    if a.device != b.device or a.shape != b.shape:
        raise ValueError("mont_mul_mxu operands differ in device or shape")
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    if n == 0:
        return out
    fn = _kernel()
    tnt, tpt = fp.const(TNT, a.device), fp.const(TPT, a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), tnt.data_ptr(), tpt.data_ptr(), out.data_ptr(), n,
            stream)
    if rc != 0:
        raise RuntimeError(f"mxu_mont kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def mont_mul_mxu_host(a, b):
    """K4's arithmetic on the CPU (`csrc/mxu_mont_host.cpp`): (n, 32) int32
    limbs → (REDC limbs (n, 32), the largest t, m or t + u column)."""
    from ..build import mxu_host

    lib = mxu_host()
    fn = lib.lodestar_mxu_mont_host
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = None
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    out = np.zeros_like(a)
    col_max = np.zeros(1, np.int32)
    fn(a.ctypes.data, b.ctypes.data, TNT.ctypes.data, TPT.ctypes.data, out.ctypes.data,
       a.shape[0], col_max.ctypes.data)
    return out, int(col_max[0])


# --- the entry ------------------------------------------------------------------

def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Drop-in for `fp.mul`: broadcast as it does; below `MIN_LANES`
    flattened products K1's entry, else K4 for CUDA tensors and its plain
    version for CPU tensors (no fallback)."""
    batch = fp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if int(np.prod(batch, dtype=np.int64)) < MIN_LANES:
        return cuda_fp.mont_mul(a, b)
    a = torch.broadcast_to(a, batch + (N_LIMBS,))
    b = torch.broadcast_to(b, batch + (N_LIMBS,))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_mxu_plain(a, b)
    return mont_mul_mxu_cuda(a.contiguous(), b.contiguous())
