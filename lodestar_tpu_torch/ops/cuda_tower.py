"""K2 and K3, the Miller loop and the fused per-set pairing, with their
main-path entry points K2p and K3-fe: the CUDA kernels, their plain
versions and their host builds.

- `miller_loop_kernel` replaces the JAX package's Pallas kernel
  `ops/pallas_tower.py::_miller_tiles` (reached through `pairing.miller_loop`
  when `LODESTAR_TPU_PALLAS_MILLER` resolves on, as it does on a TPU: the
  port hard-codes that default). On CUDA tensors it launches `miller_kernel`
  of `csrc/tower.cu` (built at first use by `build.tower_cuda`) or raises;
  on CPU tensors it runs `miller_loop_plain`, `pairing._miller_loop_impl`
  on affine P and Q.
- `miller_loop_proj_kernel` is K2 in the form the batch verdicts and the
  bisection tree call (`pairing.miller_loop_proj_pq`, P and Q homogeneous
  projective; XLA in the JAX package, whose Pallas kernel takes affine
  points only). On CUDA tensors it launches `miller_proj_warp_kernel`
  (K2p: one warp per lane over `csrc/miller_warp.cuh`, whose phase tables
  `gen_miller_sched.py` generates) or raises; on CPU tensors it runs
  `miller_loop_proj_plain`.
- `final_exp_kernel` is K3's tail alone, the final exponentiation per lane
  (`pairing.final_exponentiation_batch`, `final_exponentiation_one` and
  the per-lane `final_exponentiation`). On CUDA tensors it launches
  `final_exp_warp_kernel` (K3-fe: one warp per lane over
  `csrc/tower_warp.cuh`) or raises; on CPU tensors it runs
  `final_exp_plain`, the batch form with one shared inversion.
- `pairing_fused` replaces `ops/pallas_tower.py::_pairing_tiles` (reached
  through `individual_verify_kernel` when `LODESTAR_TPU_PALLAS_PAIRING`
  resolves on, as it does on a TPU). On CUDA tensors it launches
  `pairing_warp_kernel` (K3: two warps per set run K2p's Miller program
  at unit Z side by side, then one of them K3-fe's final exponentiation on
  the product) or raises; on CPU tensors it runs `pairing_fused_plain`:
  `individual_pairing_terms` (2n plain Miller lanes, the per-set Fp12
  product) and `final_exp_plain`.

The kernels return canonical limbs (every value below p); the plain
versions return lazy limbs in [0, 2p). They agree by canonical value:
K2 and K2p follow the plain version's formulas, and K3 and K3-fe invert
per thread where the plain version shares one inversion across the batch,
which gives the same field element. `MILLER_LAUNCHES`,
`MILLER_PROJ_LAUNCHES`, `PAIRING_LAUNCHES` and `FINAL_EXP_LAUNCHES` count
kernel launches (not plain calls), so a run can show that its path went
through the kernels.

The `*_host` functions run the kernels' own arithmetic (`csrc/tower.cuh`,
`csrc/tower_warp.cuh`) built for the CPU (`build.tower_host`), for the
tests and for the operation and round counts of the kernels' bound
(`fp_muls_per_lane`). `final_exp_host` is the one-thread final
exponentiation of tower.cuh; `final_exp_warp_host` is K3-fe's, its warp
emulated one thread after another in either order.
`pairing_fused_host` is the one-thread set (`tower.cuh` `pairing_lane`),
K3's oracle; `pairing_warp_host` is K3's own composition of the two warp
programs, its warps emulated in either order.
`miller_loop_proj_host` is the one-thread projective Miller lane
(`tower.cuh` `miller_proj_lane`), K2p's oracle; `miller_loop_proj_warp_host`
is K2p's own schedule, its warp emulated in either order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import fp, fp12
from .limbs import N_LIMBS
from .points import G1_GEN_X, G1_GEN_Y

MILLER_LAUNCHES = 0
MILLER_PROJ_LAUNCHES = 0
PAIRING_LAUNCHES = 0
FINAL_EXP_LAUNCHES = 0

FP12_SHAPE = (2, 3, 2, N_LIMBS)


# --- plain versions -----------------------------------------------------------

def miller_loop_plain(xp, yp, xq, yq):
    """conj(f_{|x|,Q}(P)) for affine P (n, 32) and Q (n, 2, 32), in PyTorch."""
    from .pairing import _miller_loop_impl

    return _miller_loop_impl(xp, yp, None, xq, yq, None)


def miller_loop_proj_plain(xp, yp, zp, xq, yq, zq):
    """conj(f_{|x|,Q}(P)) for projective P (n, 32) ×3 and Q (n, 2, 32) ×3,
    in PyTorch."""
    from .pairing import _miller_loop_impl

    return _miller_loop_impl(xp, yp, zp, xq, yq, zq)


def final_exp_plain(fs):
    """The final exponentiation over axis 0 of (n, 2, 3, 2, 32), in
    PyTorch, the easy part's inversion shared by the batch."""
    from .pairing import _final_exponentiation_batch_impl

    return _final_exponentiation_batch_impl(fs)


def pairing_lanes(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y):
    """The 2n affine Miller lanes of n signature sets: (pk_i, H_i) for the
    first n, (−g1, sig_i) for the next n."""
    n = pk_x.shape[0]
    gx = fp.const(G1_GEN_X, pk_x.device).expand(n, N_LIMBS)
    neg_gy = fp.neg(fp.const(G1_GEN_Y, pk_x.device)).expand(n, N_LIMBS)
    return (
        torch.cat([pk_x, gx], 0),
        torch.cat([pk_y, neg_gy], 0),
        torch.cat([msg_x, sig_x], 0),
        torch.cat([msg_y, sig_y], 0),
    )


def individual_pairing_terms(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y):
    """(n,) per-set products ML(pk_i, H_i)·ML(−g1, sig_i) before the final
    exponentiation, in PyTorch (the JAX package's
    `parallel/verifier.py::_individual_pairing_terms`)."""
    n = pk_x.shape[0]
    fs = miller_loop_plain(*pairing_lanes(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y))
    return fp12.mul(fs[:n], fs[n:])


def pairing_fused_plain(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y):
    """final_exp(ML(pk_i, H_i)·ML(−g1, sig_i)) per set, in PyTorch, the
    easy part's inversion shared by the batch."""
    return final_exp_plain(individual_pairing_terms(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y))


# --- CUDA kernels -------------------------------------------------------------

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong


def _kernels():
    from ..build import tower_cuda

    lib = tower_cuda()
    if lib.lodestar_miller.argtypes is None:
        lib.lodestar_miller.argtypes = [_VP] * 5 + [_LL, _VP]
        lib.lodestar_miller.restype = ctypes.c_int
        lib.lodestar_pairing.argtypes = [_VP] * 7 + [_LL, _VP]
        lib.lodestar_pairing.restype = ctypes.c_int
        lib.lodestar_miller_proj.argtypes = [_VP] * 7 + [_LL, _VP]
        lib.lodestar_miller_proj.restype = ctypes.c_int
        lib.lodestar_final_exp.argtypes = [_VP] * 2 + [_LL, _VP]
        lib.lodestar_final_exp.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {x.dtype}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {shape}, got {tuple(x.shape)}")


def miller_loop_cuda(xp, yp, xq, yq):
    """Launch K2 on contiguous int32 CUDA tensors xp, yp (n, 32) and xq, yq
    (n, 2, 32) → (n, 2, 3, 2, 32) canonical limbs."""
    global MILLER_LAUNCHES
    n = xp.shape[0]
    for name, x, shape in (("xp", xp, (n, N_LIMBS)), ("yp", yp, (n, N_LIMBS)),
                           ("xq", xq, (n, 2, N_LIMBS)), ("yq", yq, (n, 2, N_LIMBS))):
        _check(name, x, shape)
    out = torch.empty((n,) + FP12_SHAPE, dtype=torch.int32, device=xp.device)
    if n == 0:
        return out
    lib = _kernels()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.lodestar_miller(xp.data_ptr(), yp.data_ptr(), xq.data_ptr(), yq.data_ptr(),
                             out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"miller kernel launch failed: CUDA error {rc}")
    MILLER_LAUNCHES += 1
    return out


def miller_loop_proj_cuda(xp, yp, zp, xq, yq, zq):
    """Launch K2p on contiguous int32 CUDA tensors xp, yp, zp (n, 32) and
    xq, yq, zq (n, 2, 32) → (n, 2, 3, 2, 32) canonical limbs."""
    global MILLER_PROJ_LAUNCHES
    n = xp.shape[0]
    p, q = (n, N_LIMBS), (n, 2, N_LIMBS)
    for name, x, shape in (("xp", xp, p), ("yp", yp, p), ("zp", zp, p),
                           ("xq", xq, q), ("yq", yq, q), ("zq", zq, q)):
        _check(name, x, shape)
    out = torch.empty((n,) + FP12_SHAPE, dtype=torch.int32, device=xp.device)
    if n == 0:
        return out
    lib = _kernels()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.lodestar_miller_proj(xp.data_ptr(), yp.data_ptr(), zp.data_ptr(), xq.data_ptr(),
                                  yq.data_ptr(), zq.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"projective miller kernel launch failed: CUDA error {rc}")
    MILLER_PROJ_LAUNCHES += 1
    return out


def final_exp_cuda(fs):
    """Launch K3-fe on a contiguous int32 CUDA tensor (n, 2, 3, 2, 32) →
    (n, 2, 3, 2, 32) canonical final-exponentiated limbs."""
    global FINAL_EXP_LAUNCHES
    n = fs.shape[0]
    _check("fs", fs, (n,) + FP12_SHAPE)
    out = torch.empty((n,) + FP12_SHAPE, dtype=torch.int32, device=fs.device)
    if n == 0:
        return out
    lib = _kernels()
    stream = torch.cuda.current_stream(fs.device).cuda_stream
    rc = lib.lodestar_final_exp(fs.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"final exponentiation kernel launch failed: CUDA error {rc}")
    FINAL_EXP_LAUNCHES += 1
    return out


def pairing_fused_cuda(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y):
    """Launch K3 on contiguous int32 CUDA tensors pk (n, 32) and msg, sig
    (n, 2, 32) → (n, 2, 3, 2, 32) canonical final-exponentiated limbs."""
    global PAIRING_LAUNCHES
    n = pk_x.shape[0]
    p, q = (n, N_LIMBS), (n, 2, N_LIMBS)
    for name, x, shape in (("pk_x", pk_x, p), ("pk_y", pk_y, p), ("msg_x", msg_x, q),
                           ("msg_y", msg_y, q), ("sig_x", sig_x, q), ("sig_y", sig_y, q)):
        _check(name, x, shape)
    out = torch.empty((n,) + FP12_SHAPE, dtype=torch.int32, device=pk_x.device)
    if n == 0:
        return out
    lib = _kernels()
    stream = torch.cuda.current_stream(pk_x.device).cuda_stream
    rc = lib.lodestar_pairing(pk_x.data_ptr(), pk_y.data_ptr(), msg_x.data_ptr(),
                              msg_y.data_ptr(), sig_x.data_ptr(), sig_y.data_ptr(),
                              out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"pairing kernel launch failed: CUDA error {rc}")
    PAIRING_LAUNCHES += 1
    return out


# --- entries: the kernel for CUDA tensors, the plain version for CPU ones ----

def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _miller_lanes(p, q, plain, cuda):
    """A Miller loop over broadcast leading axes: P coordinates (..., 32),
    Q coordinates (..., 2, 32) → (..., 2, 3, 2, 32), flattened to lanes
    for `plain` (CPU tensors) or `cuda`. A scalar call runs as one lane."""
    batch = fp.broadcast_shapes(*(x.shape[:-1] for x in p), *(x.shape[:-2] for x in q))
    flat = [torch.broadcast_to(x, batch + (N_LIMBS,)).reshape(-1, N_LIMBS) for x in p]
    flat += [torch.broadcast_to(x, batch + (2, N_LIMBS)).reshape(-1, 2, N_LIMBS) for x in q]
    if _on_cpu(*flat):
        out = plain(*flat)
    else:
        out = cuda(*(x.contiguous() for x in flat))
    return out.reshape(batch + FP12_SHAPE)


def miller_loop_kernel(p_aff, q_aff):
    """The affine Miller loop: P (xp, yp) (..., 32), Q (xq, yq) (..., 2, 32)
    → (..., 2, 3, 2, 32); a scalar call gets a unit batch axis inside, as
    `pallas_tower.miller_loop_pallas` gives it."""
    return _miller_lanes(p_aff, q_aff, miller_loop_plain, miller_loop_cuda)


def miller_loop_proj_kernel(p_proj, q_proj):
    """The projective Miller loop: P (xp, yp, zp) (..., 32), Q (xq, yq, zq)
    (..., 2, 32) → (..., 2, 3, 2, 32)."""
    return _miller_lanes(p_proj, q_proj, miller_loop_proj_plain, miller_loop_proj_cuda)


def final_exp_kernel(fs):
    """The final exponentiation of every lane of fs (..., 2, 3, 2, 32); a
    single element gets a unit batch axis."""
    batch = tuple(fs.shape[:-4])
    flat = fs.reshape((-1,) + FP12_SHAPE)
    if _on_cpu(flat):
        out = final_exp_plain(flat)
    else:
        out = final_exp_cuda(flat.contiguous())
    return out.reshape(batch + FP12_SHAPE)


def pairing_fused(pk_aff, msg_aff, sig_aff):
    """Per-set final_exp(ML(pk_i, H_i)·ML(−g1, sig_i)): pk (n, 32), msg and
    sig (n, 2, 32) → (n, 2, 3, 2, 32); callers finish with
    `fp12.is_one(...) & valid`."""
    args = (*pk_aff, *msg_aff, *sig_aff)
    if _on_cpu(*args):
        return pairing_fused_plain(*args)
    return pairing_fused_cuda(*(x.contiguous() for x in args))


# --- the kernels' arithmetic built for the host -------------------------------

def _host():
    from ..build import tower_host

    lib = tower_host()
    if lib.lodestar_tower_fp_muls.argtypes is None:
        for name, n_ptr in (("lodestar_miller_host", 5), ("lodestar_miller_proj_host", 7),
                            ("lodestar_pairing_host", 7), ("lodestar_final_exp_host", 2)):
            fn = getattr(lib, name)
            fn.argtypes = [_VP] * n_ptr + [_LL]
            fn.restype = None
        lib.lodestar_miller_proj_warp_host.argtypes = [_VP] * 7 + [_LL, ctypes.c_int]
        lib.lodestar_miller_proj_warp_host.restype = None
        lib.lodestar_pairing_warp_host.argtypes = [_VP] * 7 + [_LL, ctypes.c_int]
        lib.lodestar_pairing_warp_host.restype = None
        lib.lodestar_final_exp_warp_host.argtypes = [_VP, _VP, _LL, ctypes.c_int]
        lib.lodestar_final_exp_warp_host.restype = None
        lib.lodestar_fp_inv_host.argtypes = [_VP, _VP, _LL, ctypes.c_int]
        lib.lodestar_fp_inv_host.restype = None
        lib.lodestar_fp_mul_host.argtypes = [_VP, _VP, _VP, _LL]
        lib.lodestar_fp_mul_host.restype = None
        lib.lodestar_tower_warp_stats.argtypes = [_VP, ctypes.c_int]
        lib.lodestar_tower_warp_stats.restype = None
        lib.lodestar_tower_fp_muls.argtypes = [ctypes.c_int]
        lib.lodestar_tower_fp_muls.restype = ctypes.c_ulonglong
    return lib


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.int32)


def _run_host(name: str, ins: list, n: int) -> np.ndarray:
    arrs = [_np(x) for x in ins]
    out = np.zeros((n,) + FP12_SHAPE, np.int32)
    getattr(_host(), name)(*(a.ctypes.data for a in arrs), out.ctypes.data, n)
    return out


def miller_loop_host(xp, yp, xq, yq) -> np.ndarray:
    """K2's arithmetic on the CPU: (n, 32) ×2, (n, 2, 32) ×2 → (n, 2, 3, 2, 32)."""
    return _run_host("lodestar_miller_host", [xp, yp, xq, yq], int(np.shape(xp)[0]))


def miller_loop_proj_host(xp, yp, zp, xq, yq, zq) -> np.ndarray:
    """K2p's arithmetic on the CPU: (n, 32) ×3, (n, 2, 32) ×3 → (n, 2, 3, 2, 32)."""
    return _run_host("lodestar_miller_proj_host", [xp, yp, zp, xq, yq, zq],
                     int(np.shape(xp)[0]))


def miller_loop_proj_warp_host(xp, yp, zp, xq, yq, zq, reverse: bool = False) -> np.ndarray:
    """K2p's arithmetic on the CPU, its warp emulated: each phase runs
    thread 0..31 in turn, or 31..0 with `reverse`; (n, 32) ×3, (n, 2, 32)
    ×3 → (n, 2, 3, 2, 32)."""
    arrs = [_np(x) for x in (xp, yp, zp, xq, yq, zq)]
    n = int(arrs[0].shape[0])
    out = np.zeros((n,) + FP12_SHAPE, np.int32)
    _host().lodestar_miller_proj_warp_host(*(a.ctypes.data for a in arrs), out.ctypes.data, n,
                                           int(reverse))
    return out


def pairing_fused_host(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y) -> np.ndarray:
    """The one-thread fused pairing on the CPU (`tower.cuh` `pairing_lane`,
    K3's oracle): n sets → (n, 2, 3, 2, 32)."""
    return _run_host("lodestar_pairing_host", [pk_x, pk_y, msg_x, msg_y, sig_x, sig_y],
                     int(np.shape(pk_x)[0]))


def pairing_warp_host(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y,
                      reverse: bool = False) -> np.ndarray:
    """K3's arithmetic on the CPU as `pairing_warp_kernel` runs it: per set
    the two Miller warps, then the tail, each phase's threads run 0..31 in
    turn, or 31..0 (and the second Miller warp first) with `reverse`;
    n sets → (n, 2, 3, 2, 32)."""
    arrs = [_np(x) for x in (pk_x, pk_y, msg_x, msg_y, sig_x, sig_y)]
    n = int(arrs[0].shape[0])
    out = np.zeros((n,) + FP12_SHAPE, np.int32)
    _host().lodestar_pairing_warp_host(*(a.ctypes.data for a in arrs), out.ctypes.data, n,
                                       int(reverse))
    return out


def final_exp_host(fs) -> np.ndarray:
    """K3-fe's arithmetic (K3's tail) on the CPU, per lane."""
    return _run_host("lodestar_final_exp_host", [fs], int(np.shape(fs)[0]))


def final_exp_warp_host(fs, reverse: bool = False) -> np.ndarray:
    """K3-fe's arithmetic on the CPU, per lane, its warp emulated: each
    phase runs thread 0..31 in turn, or 31..0 with `reverse`."""
    a = _np(fs)
    n = int(a.shape[0])
    out = np.zeros((n,) + FP12_SHAPE, np.int32)
    _host().lodestar_final_exp_warp_host(a.ctypes.data, out.ctypes.data, n, int(reverse))
    return out


def fp_inv_host(x, euclid: bool = True) -> np.ndarray:
    """(n, 32) limbs → their Fp inverses as canonical limbs (0 → 0): K3-fe's
    binary extended Euclid, or with `euclid=False` the one-thread tower's
    Fermat inverse."""
    a = _np(x)
    out = np.zeros_like(a)
    _host().lodestar_fp_inv_host(a.ctypes.data, out.ctypes.data, int(a.shape[0]), int(euclid))
    return out


def fp_mul_host(a, b) -> np.ndarray:
    """(n, 32) limbs a, b → a·b·R⁻¹ mod p as canonical limbs (inputs
    reduced first), by K3-fe's FIOS multiply."""
    x, y = _np(a), _np(b)
    out = np.zeros_like(x)
    _host().lodestar_fp_mul_host(x.ctypes.data, y.ctypes.data, out.ctypes.data,
                                 int(x.shape[0]))
    return out


def warp_stats(reset: bool = True) -> dict[str, int]:
    """Over the warp-emulated lanes since the last reset: phases, rounds
    (the most Fp multiplies one thread did in a phase, summed over the
    phases: the dependent multiplies of a lane) and the phases in which a
    thread multiplied more than once (0 by design)."""
    out = (ctypes.c_ulonglong * 3)()
    _host().lodestar_tower_warp_stats(out, int(reset))
    return {"phases": int(out[0]), "rounds": int(out[1]), "overfull": int(out[2])}


def fp_muls_per_lane() -> dict[str, int]:
    """Fp multiplies one lane of each kernel runs (data-independent: the
    loops follow the fixed bits of |x| and of p − 2, and the Euclid inverse
    makes none but its last), counted on the host build over one all-zero
    lane. `final_exp_warp` is K3-fe's schedule and `final_exp_warp_rounds`
    its dependent rounds per lane; `final_exp_fewest` is the fewest that
    the final exponentiation needs among the repo's schedules, the count
    of K3-fe's bound: the one-thread lane (`final_exp`, 18 products per
    cyclotomic squaring) with its Fermat inverse replaced by the Euclid
    inverse. `miller_loop_proj` is the one-thread projective lane,
    `miller_loop_proj_warp` K2p's schedule and `miller_loop_proj_warp_rounds`
    its dependent rounds; `miller_loop_proj_fewest`, the smaller of the two
    counts, is the count of K2p's bound. `pairing_fused` is the one-thread
    set (two Miller loops on one squaring chain, Fermat's inverse),
    `pairing_warp` K3's schedule and `pairing_warp_rounds` its dependent
    rounds per set (the two Miller warps run side by side, so one warp's
    rounds count once); `pairing_fewest`, the count of K3's bound, is the
    one-thread set's Miller part (its multiplies less its final
    exponentiation's) plus `final_exp_fewest`."""
    lib = _host()
    zp = np.zeros((1, N_LIMBS), np.int32)
    zq = np.zeros((1, 2, N_LIMBS), np.int32)
    lib.lodestar_tower_fp_muls(1)
    miller_loop_host(zp, zp, zq, zq)
    miller = int(lib.lodestar_tower_fp_muls(1))
    miller_loop_proj_host(zp, zp, zp, zq, zq, zq)
    miller_proj = int(lib.lodestar_tower_fp_muls(1))
    warp_stats(reset=True)
    miller_loop_proj_warp_host(zp, zp, zp, zq, zq, zq)
    miller_proj_warp = int(lib.lodestar_tower_fp_muls(1))
    miller_rounds = warp_stats(reset=True)["rounds"]
    pairing_fused_host(zp, zp, zq, zq, zq, zq)
    pairing = int(lib.lodestar_tower_fp_muls(1))
    warp_stats(reset=True)
    pairing_warp_host(zp, zp, zq, zq, zq, zq)
    pairing_warp = int(lib.lodestar_tower_fp_muls(1))
    pairing_rounds = warp_stats(reset=True)["rounds"] - miller_rounds
    final_exp_host(np.zeros((1,) + FP12_SHAPE, np.int32))
    final_exp = int(lib.lodestar_tower_fp_muls(1))
    warp_stats(reset=True)
    final_exp_warp_host(np.zeros((1,) + FP12_SHAPE, np.int32))
    final_exp_warp = int(lib.lodestar_tower_fp_muls(1))
    rounds = warp_stats(reset=True)["rounds"]
    fp_inv_host(zp, euclid=False)
    fermat = int(lib.lodestar_tower_fp_muls(1))
    fp_inv_host(zp, euclid=True)
    euclid = int(lib.lodestar_tower_fp_muls(1))
    fewest_fe = final_exp - fermat + euclid
    return {"miller_loop": miller, "miller_loop_proj": miller_proj,
            "miller_loop_proj_warp": miller_proj_warp,
            "miller_loop_proj_warp_rounds": miller_rounds,
            "miller_loop_proj_fewest": min(miller_proj, miller_proj_warp),
            "pairing_fused": pairing, "pairing_warp": pairing_warp,
            "pairing_warp_rounds": pairing_rounds,
            "pairing_fewest": pairing - final_exp + fewest_fe,
            "final_exp": final_exp,
            "final_exp_warp": final_exp_warp, "final_exp_warp_rounds": rounds,
            "final_exp_fewest": fewest_fe}
