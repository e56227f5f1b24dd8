"""K1, the Montgomery field multiply: the CUDA kernel, its plain version
and its host builds.

`mont_mul` replaces the JAX package's Pallas kernel
`ops/pallas_fp.py::_mont_mul_kernel` (reached through `fp.mul` with
`LODESTAR_TPU_PALLAS_MUL=1`). On CUDA tensors it launches the
hand-written sm_90a kernel of `csrc/mont_mul.cu` (a half-warp per
product over `csrc/fp_mont_group.cuh`, built at first use by
`build.mont_mul_cuda`) or raises; on CPU tensors it runs
`mont_mul_plain`, the port of the JAX word-serial multiply `_mul_scan`.
Both give REDC(a·b) = a·b·2⁻³⁸⁴ mod p in [0, 2p), limb for limb.

`LAUNCHES` counts kernel launches (not plain calls), so a run can show
that its main path went through the kernel.

`mont_mul_group_host` runs the kernel's own half-warp code on the CPU
(`build.mont_mul_host`), the group's shuffles emulated with its lanes
resumed in either order; `mont_mul_host` is the one-thread CIOS of
`csrc/fp_mont.cuh`, its oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import fp
from .limbs import N_LIMBS

LAUNCHES = 0


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-serial Montgomery multiply: the 64-column convolution, then
    the digit-serial REDC with its carry (see `fp._redc`)."""
    return fp._redc(fp.conv_cols(a, b))


def _kernel():
    from ..build import mont_mul_cuda

    lib = mont_mul_cuda()
    fn = lib.lodestar_mont_mul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on same-shape contiguous int32 (..., 32) CUDA tensors."""
    global LAUNCHES
    for x in (a, b):
        if not x.is_cuda:
            raise ValueError("mont_mul_cuda takes CUDA tensors")
        if x.dtype != torch.int32:
            raise TypeError(f"mont_mul takes int32 limbs, got {x.dtype}")
        if x.shape[-1:] != (N_LIMBS,) or not x.is_contiguous():
            raise ValueError("mont_mul takes contiguous (..., 32) limbs")
    if a.device != b.device or a.shape != b.shape:
        raise ValueError("mont_mul operands differ in device or shape")
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    if n == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Drop-in for `fp.mul`: broadcast as it does, then the kernel for
    CUDA tensors and the plain version for CPU tensors (no fallback)."""
    batch = fp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = torch.broadcast_to(a, batch + (N_LIMBS,))
    b = torch.broadcast_to(b, batch + (N_LIMBS,))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b)
    return mont_mul_cuda(a.contiguous(), b.contiguous())


# --- the kernel's arithmetic built for the host -------------------------------

def _host():
    from ..build import mont_mul_host

    lib = mont_mul_host()
    if lib.lodestar_mont_mul_group_host.argtypes is None:
        lib.lodestar_mont_mul_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
        lib.lodestar_mont_mul_host.restype = None
        lib.lodestar_mont_mul_group_host.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int]
        lib.lodestar_mont_mul_group_host.restype = ctypes.c_longlong
    return lib


def _rows(a, b) -> tuple[np.ndarray, np.ndarray]:
    x = np.ascontiguousarray(a, dtype=np.int32)
    y = np.ascontiguousarray(b, dtype=np.int32)
    if x.shape != y.shape or x.ndim != 2 or x.shape[1] != N_LIMBS:
        raise ValueError("the host builds take two (n, 32) limb arrays of one shape")
    return x, y


def mont_mul_host(a, b) -> np.ndarray:
    """(n, 32) limbs a, b < 2p → REDC(a·b) by the one-thread CIOS of
    `csrc/fp_mont.cuh`."""
    x, y = _rows(a, b)
    out = np.zeros_like(x)
    _host().lodestar_mont_mul_host(x.ctypes.data, y.ctypes.data, out.ctypes.data, len(x))
    return out


def mont_mul_group_host(a, b, reverse: bool = False) -> np.ndarray:
    """(n, 32) limbs a, b < 2p → REDC(a·b) by K1's half-warp code
    (`csrc/fp_mont_group.cuh`), each product's 16 lanes emulated, resumed
    in order 0..15 or, with `reverse`, 15..0."""
    x, y = _rows(a, b)
    out = np.zeros_like(x)
    if _host().lodestar_mont_mul_group_host(x.ctypes.data, y.ctypes.data, out.ctypes.data,
                                            len(x), int(reverse)) < 0:
        raise RuntimeError("the lanes of a group made different exchanges")
    return out
