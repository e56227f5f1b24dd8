"""Batch and per-set verification of BLS signature sets.

The port of the JAX package's two verdicts behind `IBlsVerifier`:

- `verify_signature_sets` (`TpuBlsVerifier.verify_signature_sets` →
  `_plan_groups` → `_submit_grouped` → `_marshal_grouped(raw=True)` →
  `grouped_verify_kernel_raw`), root-grouped. Sets that share a signing
  root are grouped into R rows × L lanes and checked with ONE random
  linear combination,

      Π_j e(Σ_{i∈j} r_i·pk_i, H_j) · e(−g1, Σ_i r_i·sig_i) == 1,

  with r_i = a_i + z·b_i (a, b uniform 32-bit; the GLS split), bit-plane
  MSMs for both sums, 2R + 64 projective Miller lanes, one Fp12 product,
  one final exponentiation and the batched plane subgroup check of the
  signatures, which stay compressed wire bytes until the device decodes
  them. The verdict is one bit, all or nothing.
- `verify_signature_sets_individual` (`TpuBlsVerifier`'s per-set verdicts,
  the retry path after a failed batch), by bisection: the sets are
  marshalled on the host into a bucket of (4, 16, 64, 128) lanes,
  `bisect_tree_kernel` builds randomised per-set terms
  f_i = ML(r_i·pk_i, H_i)·ML(−g1, r_i·sig_i) (64-bit r_i) and every level
  of their product tree, and one final exponentiation of the root decides
  the all-valid case. A failed root is binary-searched with 16-lane probe
  final exponentiations (`_bisect`). The exact per-set kernel
  `individual_verify_kernel` (K3, the fused pairing, on the GPU) takes the
  2⁻⁶⁴ cancellation fallback and every set of a batch that does not
  marshal (`_verify_one`).

A batch the root-grouped planner refuses goes on down the JAX package's
planner (`TpuBlsVerifier.verify_signature_sets_submit`), in its order:

- pk-grouped (`_plan_pk_groups` → `_submit_pk_grouped` →
  `_marshal_pk_grouped` → `pk_grouped_verify_kernel_raw`), the
  dual layout for unique roots signed by a bounded set of keys: one pubkey
  per row, Π_k e(pk_k, Σ_{i∈k} r_i·H_i)·e(−g1, Σ_i r_i·sig_i) == 1, R + 64
  Miller lanes, the per-row message sums by G2 bit-plane MSM and Horner;
- split (`_split_shared_unique`): the shared-root sets go root-grouped,
  the singleton-root rest pk-grouped, else flat;
- flat (`_submit_flat` → `_marshal(raw=True)` → `batch_verify_kernel_raw`),
  in chunks of the largest bucket: per set r_i·pk_i by a 64-step G1
  ladder, the signatures' 64 bit-planes against −[2^b]g1, N + 64 Miller
  lanes; the resolver ANDs the chunks. A batch outside the 32 B root /
  96 B signature shape takes this path with host-decoded signatures
  (`batch_verify_kernel`).

Every Fp multiply of these paths goes through `fp.mul`: K4 (the integer
tensor-core multiply) from 4096 products up, K1 below.
"""

from __future__ import annotations

import contextlib
import os
import secrets
import threading
import time
from collections import Counter

import numpy as np
import torch

from ..bls.api import DST_G2
from ..device import resolve_device
from ..observability.stages import NULL_OBSERVER
from ..ops import cuda_tower, fp, fp2, fp12, msm
from ..ops.g2_decompress import decompress, planes_in_subgroup
from ..ops.pairing import (
    final_exponentiation_batch,
    final_exponentiation_one,
    miller_loop_proj_pq,
)
from ..ops.points import (
    G1_GEN_X,
    G1_GEN_Y,
    NEG_G1_POW2_64_X,
    NEG_G1_POW2_64_Y,
    NEG_G1_POW2_X,
    NEG_G1_POW2_Y,
    g1,
    g2,
    g2_psi,
)
from .epoch_table import EpochPubkeyTable

N_LIMBS = 32
R_BITS = 64  # the per-set random coefficients of the bisection tree
HALF_BITS = 32  # the a/b halves of the r = a + z·b split
PROBE_LANES = 16  # lanes of one bisection probe (one fixed shape)
BUCKETS = (4, 16, 64, 128)  # per-set lane buckets; 128 = a block's attestations
H2C_CACHE_MAX = 8192
# the JAX package reads LODESTAR_TPU_PK_CACHE_MAX (default 2^21, every
# active mainnet validator); the port keeps the default
PK_CACHE_MAX = 1 << 21

__all__ = [
    "GroupedArrays",
    "PkGroupedArrays",
    "SetArrays",
    "TorchBlsVerifier",
    "batch_verify_kernel",
    "batch_verify_kernel_raw",
    "bisect_probe_kernel",
    "bisect_tree_kernel",
    "final_exp_batch_kernel",
    "grouped_verify_kernel",
    "grouped_verify_kernel_raw",
    "individual_verify_kernel",
    "pk_grouped_verify_kernel",
    "pk_grouped_verify_kernel_raw",
]


class SetArrays:
    """Host-marshalled signature sets, padded to a fixed lane count."""

    __slots__ = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y", "valid", "n")

    def __init__(self, lanes: int):
        self.pk_x = np.zeros((lanes, N_LIMBS), np.int32)
        self.pk_y = np.zeros((lanes, N_LIMBS), np.int32)
        self.msg_x = np.zeros((lanes, 2, N_LIMBS), np.int32)
        self.msg_y = np.zeros((lanes, 2, N_LIMBS), np.int32)
        self.sig_x = np.zeros((lanes, 2, N_LIMBS), np.int32)
        self.sig_y = np.zeros((lanes, 2, N_LIMBS), np.int32)
        self.valid = np.zeros((lanes,), bool)
        self.n = 0


class GroupedArrays:
    """Signature sets grouped by signing root into (R rows × L lanes)."""

    __slots__ = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y", "valid", "n")

    def __init__(self, rows: int, lanes: int):
        self.pk_x = np.zeros((rows, lanes, N_LIMBS), np.int32)
        self.pk_y = np.zeros((rows, lanes, N_LIMBS), np.int32)
        self.msg_x = np.zeros((rows, 2, N_LIMBS), np.int32)
        self.msg_y = np.zeros((rows, 2, N_LIMBS), np.int32)
        self.sig_x = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.sig_y = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.valid = np.zeros((rows, lanes), bool)
        self.n = 0


class PkGroupedArrays:
    """Signature sets grouped by PUBKEY into (R rows × L lanes): one pubkey
    per row, per-lane messages and signatures (the dual layout)."""

    __slots__ = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y", "valid", "n")

    def __init__(self, rows: int, lanes: int):
        self.pk_x = np.zeros((rows, N_LIMBS), np.int32)
        self.pk_y = np.zeros((rows, N_LIMBS), np.int32)
        self.msg_x = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.msg_y = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.sig_x = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.sig_y = np.zeros((rows, lanes, 2, N_LIMBS), np.int32)
        self.valid = np.zeros((rows, lanes), bool)
        self.n = 0


# --- host marshalling pool ---------------------------------------------------
#
# The C host tier's ctypes calls release the GIL, so a pool of threads as
# large as the host's cores hashes many roots at once.

_MARSHAL_CHUNK = 256  # sets per pool task
_POOL = None
_POOL_SIZE = 0


def marshal_pool_size() -> int:
    """The host's cores (the JAX package's default, without its
    LODESTAR_TPU_MARSHAL_THREADS override)."""
    return os.cpu_count() or 1


def _marshal_pool():
    """The shared ThreadPoolExecutor, or None on a one-core host."""
    global _POOL, _POOL_SIZE
    size = marshal_pool_size()
    if size <= 1:
        return None
    if _POOL is None or _POOL_SIZE != size:
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(max_workers=size, thread_name_prefix="bls-marshal")
        _POOL_SIZE = size
    return _POOL


def _rand_bits(lanes: int, rng=None) -> np.ndarray:
    """(lanes, 64) int32 bits, MSB first, of nonzero 64-bit coefficients.

    By default each is a CSPRNG draw (`secrets.randbits(64)`, as in the
    JAX package): the bisection tree's shortcuts are sound only while the
    coefficients are unpredictable. A caller may pass `rng`: a numpy
    Generator, or a callable returning 64-bit words."""
    mask = (1 << R_BITS) - 1
    if rng is None:
        rng = lambda: secrets.randbits(R_BITS)  # noqa: E731
    if isinstance(rng, np.random.Generator):
        vals = rng.integers(0, 1 << R_BITS, size=lanes, dtype=np.uint64)
        while (vals == 0).any():
            zero = vals == 0
            vals[zero] = rng.integers(0, 1 << R_BITS, size=int(zero.sum()), dtype=np.uint64)
    else:
        words = []
        for _ in range(lanes):
            r = 0
            while r == 0:
                r = rng() & mask
            words.append(r)
        vals = np.array(words, np.uint64)
    shifts = np.arange(R_BITS - 1, -1, -1, dtype=np.uint64)[None, :]
    return ((vals[:, None] >> shifts) & np.uint64(1)).astype(np.int32)


def _rand_pairs(shape: tuple[int, ...], rng=None):
    """LSB-first bit planes of the GLS-split coefficients r = a + z·b.

    Returns (a_bits, b_bits), each shape + (32,) int32 in {0, 1}, with
    (a, b) uniform 32-bit and (0, 0) excluded. By default the draw comes
    from a generator seeded with 128 CSPRNG bits (`secrets`): the batch
    equation is sound only while the coefficients are unpredictable. A
    caller may pass `rng`: a numpy Generator, or a callable returning
    64-bit words split as (low, high) = (a, b) as in the JAX package."""
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if rng is None:
        rng = np.random.default_rng(secrets.randbits(128))
    if isinstance(rng, np.random.Generator):
        a = rng.integers(0, 1 << HALF_BITS, size=count, dtype=np.uint64)
        b = rng.integers(0, 1 << HALF_BITS, size=count, dtype=np.uint64)
    else:
        vals = [rng() for _ in range(count)]
        a = np.array([v & 0xFFFFFFFF for v in vals], np.uint64)
        b = np.array([v >> HALF_BITS for v in vals], np.uint64)
    a[(a == 0) & (b == 0)] = 1
    shifts = np.arange(HALF_BITS, dtype=np.uint64)[None, :]
    a_bits = ((a[:, None] >> shifts) & 1).astype(np.int32).reshape(shape + (HALF_BITS,))
    b_bits = ((b[:, None] >> shifts) & 1).astype(np.int32).reshape(shape + (HALF_BITS,))
    return a_bits, b_bits


def _no_stage(_name: str):
    return contextlib.nullcontext()


def grouped_verify_kernel(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid):
    """The grouped verdict on affine limb tensors (signatures decoded)."""
    return _grouped_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid,
        check_planes=False,
    )


def grouped_verify_kernel_raw(
    pk_x, pk_y, msg_x, msg_y, sig_raw, a_bits, b_bits, valid, stage=_no_stage
):
    """`grouped_verify_kernel` on RAW 96-byte compressed signatures
    (R, L, 96): device decompression plus the plane subgroup checks.
    `stage(name)` gives a context manager around each stage (the JAX
    package's named scopes); `profile_verdict.py` times them with it."""
    with stage("g2_decompress"):
        sig_x, sig_y, dec_ok = decompress(sig_raw)
        decode_fail = torch.any(valid & ~dec_ok)
    verdict = _grouped_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits,
        valid & dec_ok, check_planes=True, stage=stage,
    )
    return verdict & ~decode_fail


def _grouped_verify_impl(
    pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid, check_planes,
    stage=_no_stage,
):
    """Batch verification grouped by signing root.

    Shapes: pk_* (R, L, 32); msg_* (R, 2, 32), one H(m) per row; sig_*
    (R, L, 2, 32); a_bits/b_bits (R, L, 32) LSB first; valid (R, L) bool;
    L % 4 == 0. Padding lanes and rows are masked to infinity and
    contribute 1. Returns a 0-dim bool tensor."""
    dev = pk_x.device
    R, L = pk_x.shape[0], pk_x.shape[1]
    n = R * L
    pk = (pk_x, pk_y, fp.one((R, L), dev))
    pk = g1.select(valid, pk, g1.infinity((R, L), dev))
    bits = torch.cat([a_bits, b_bits], dim=-1)  # (R, L, 64)

    # per-root bit-plane sums (64, R), then A_j and B_j by one Horner
    # over (2, R) lanes
    with stage("msm_g1"):
        t_planes = msm.masked_plane_sums(g1, pk, bits)
        tp = tuple(c.reshape((2, HALF_BITS) + tuple(c.shape[1:])) for c in t_planes)
        tp = tuple(torch.movedim(c, 1, 0) for c in tp)  # (32, 2, R, 32)
        ab = msm.horner_pow2(g1, tp)
    a_pt = tuple(c[0] for c in ab)
    b_pt = tuple(c[1] for c in ab)

    # signature side: global bit-plane sums over all N lanes
    with stage("msm_g2"):
        sig = (
            sig_x.reshape((n, 2, N_LIMBS)),
            sig_y.reshape((n, 2, N_LIMBS)),
            fp2.one((n,), dev),
        )
        sig = g2.select(valid.reshape(n), sig, g2.infinity((n,), dev))
        u_planes = msm.masked_plane_sums(g2, sig, bits.reshape(n, 2 * HALF_BITS))
        u_a = tuple(c[:HALF_BITS] for c in u_planes)
        u_b = g2_psi(tuple(c[HALF_BITS:] for c in u_planes))

    # Miller lanes: (A_j, H_j), (B_j, ψH_j), (−[2^b]g1, U_b), (−[2^b]g1, ψU'_b)
    with stage("miller_loop"):
        h = (msg_x, msg_y, fp2.one((R,), dev))
        psi_h = g2_psi(h)
        neg_x = fp.const(NEG_G1_POW2_X, dev)
        neg_y = fp.const(NEG_G1_POW2_Y, dev)
        px = torch.cat([a_pt[0], b_pt[0], neg_x, neg_x], 0)
        py = torch.cat([a_pt[1], b_pt[1], neg_y, neg_y], 0)
        pz = torch.cat([a_pt[2], b_pt[2], fp.one((2 * HALF_BITS,), dev)], 0)
        qx = torch.cat([h[0], psi_h[0], u_a[0], u_b[0]], 0)
        qy = torch.cat([h[1], psi_h[1], u_a[1], u_b[1]], 0)
        qz = torch.cat([h[2], psi_h[2], u_a[2], u_b[2]], 0)
        # e(O, ·) = e(·, O) = 1: mask infinity lanes (empty rows, zero planes)
        lane_ok = ~g1.is_infinity((px, py, pz)) & ~g2.is_infinity((qx, qy, qz))
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
        fs = fp12.select(lane_ok, fs, fp12.one((2 * R + 2 * HALF_BITS,), dev))
    with stage("product_tree"):
        prod = fp12.product_tree(fs)
    with stage("final_exp"):
        verdict = fp12.is_one(final_exponentiation_one(prod))
    if check_planes:
        with stage("plane_subgroup"):
            verdict = verdict & planes_in_subgroup(u_planes)
    return verdict


def pk_grouped_verify_kernel(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid):
    """The pk-grouped verdict on affine limb tensors (signatures decoded)."""
    return _pk_grouped_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid,
        check_planes=False,
    )


def pk_grouped_verify_kernel_raw(
    pk_x, pk_y, msg_x, msg_y, sig_raw, a_bits, b_bits, valid, stage=_no_stage
):
    """`pk_grouped_verify_kernel` on RAW 96-byte compressed signatures
    (R, L, 96): device decompression plus the plane subgroup checks; a
    valid lane whose signature does not decode makes the verdict False."""
    with stage("g2_decompress"):
        sig_x, sig_y, dec_ok = decompress(sig_raw)
        decode_fail = torch.any(valid & ~dec_ok)
    verdict = _pk_grouped_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits,
        valid & dec_ok, check_planes=True, stage=stage,
    )
    return verdict & ~decode_fail


def _pk_grouped_verify_impl(
    pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid, check_planes,
    stage=_no_stage,
):
    """Batch verification grouped by PUBKEY, the dual of the root-grouped
    verdict: for unique roots signed by a bounded set of keys,

        Π_k e(pk_k, Σ_{i∈k} r_i·H_i) · e(−g1, Σ_i r_i·sig_i) == 1

    with R + 64 Miller lanes. The per-row message sums are G2 bit-plane
    MSMs (GLS-split coefficients, ψ on the b half, one 32-step Horner over
    (2, R) lanes); the signature side is the grouped verdict's.

    Shapes: pk_* (R, 32), one pubkey per row; msg_*, sig_* (R, L, 2, 32);
    a_bits/b_bits (R, L, 32) LSB first; valid (R, L); L % 4 == 0. Returns
    a 0-dim bool tensor."""
    dev = pk_x.device
    R, L = msg_x.shape[0], msg_x.shape[1]
    n = R * L
    msgs = (msg_x, msg_y, fp2.one((R, L), dev))
    msgs = g2.select(valid, msgs, g2.infinity((R, L), dev))
    bits = torch.cat([a_bits, b_bits], dim=-1)  # (R, L, 64)

    # per-row message bit-plane sums (64, R), then Σ r_i·H_i per row
    with stage("msm_msg"):
        m_planes = msm.masked_plane_sums(g2, msgs, bits)
        tp = tuple(c.reshape((2, HALF_BITS) + tuple(c.shape[1:])) for c in m_planes)
        tp = tuple(torch.movedim(c, 1, 0) for c in tp)  # (32, 2, R, 2, 32)
        ab = msm.horner_pow2(g2, tp)
        q_row = g2.add(tuple(c[0] for c in ab), g2_psi(tuple(c[1] for c in ab)))

    with stage("msm_g2"):
        sig = (
            sig_x.reshape((n, 2, N_LIMBS)),
            sig_y.reshape((n, 2, N_LIMBS)),
            fp2.one((n,), dev),
        )
        sig = g2.select(valid.reshape(n), sig, g2.infinity((n,), dev))
        u_planes = msm.masked_plane_sums(g2, sig, bits.reshape(n, 2 * HALF_BITS))
        u_a = tuple(c[:HALF_BITS] for c in u_planes)
        u_b = g2_psi(tuple(c[HALF_BITS:] for c in u_planes))

    # Miller lanes: (pk_k, Q_k), (−[2^b]g1, U_b), (−[2^b]g1, ψU'_b)
    with stage("miller_loop"):
        neg_x = fp.const(NEG_G1_POW2_X, dev)
        neg_y = fp.const(NEG_G1_POW2_Y, dev)
        px = torch.cat([pk_x, neg_x, neg_x], 0)
        py = torch.cat([pk_y, neg_y, neg_y], 0)
        pz = torch.cat([fp.one((R,), dev), fp.one((2 * HALF_BITS,), dev)], 0)
        qx = torch.cat([q_row[0], u_a[0], u_b[0]], 0)
        qy = torch.cat([q_row[1], u_a[1], u_b[1]], 0)
        qz = torch.cat([q_row[2], u_a[2], u_b[2]], 0)
        lane_ok = ~g1.is_infinity((px, py, pz)) & ~g2.is_infinity((qx, qy, qz))
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
        fs = fp12.select(lane_ok, fs, fp12.one((R + 2 * HALF_BITS,), dev))
    with stage("product_tree"):
        prod = fp12.product_tree(fs)
    with stage("final_exp"):
        verdict = fp12.is_one(final_exponentiation_one(prod))
    if check_planes:
        with stage("plane_subgroup"):
            verdict = verdict & planes_in_subgroup(u_planes)
    return verdict


def batch_verify_kernel(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid):
    """The flat verdict on affine limb tensors (signatures decoded)."""
    return _batch_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid, check_planes=False,
    )


def batch_verify_kernel_raw(pk_x, pk_y, msg_x, msg_y, sig_raw, r_bits, valid,
                            stage=_no_stage):
    """`batch_verify_kernel` on RAW 96-byte compressed signatures (N, 96):
    device decompression plus the plane subgroup checks; a valid lane whose
    signature does not decode makes the verdict False."""
    with stage("g2_decompress"):
        sig_x, sig_y, dec_ok = decompress(sig_raw)
        decode_fail = torch.any(valid & ~dec_ok)
    verdict = _batch_verify_impl(
        pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid & dec_ok,
        check_planes=True, stage=stage,
    )
    return verdict & ~decode_fail


def _batch_verify_impl(
    pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid, check_planes,
    stage=_no_stage,
):
    """All-or-nothing verification of N sets with nothing shared,

        Π_i e(r_i·pk_i, H(m_i)) · e(−g1, Σ_i r_i·sig_i) == 1:

    r_i·pk_i by a 64-step G1 ladder per set (projective), the signature
    side as 64 bit-plane sums U_b paired against −[2^b]g1, N + 64 Miller
    lanes, one product and one final exponentiation.

    Shapes: pk_* (N, 32); msg_*, sig_* (N, 2, 32); r_bits (N, 64) MSB
    first; valid (N,), False on padding lanes. Returns a 0-dim bool."""
    dev = pk_x.device
    n = pk_x.shape[0]
    with stage("scalar_mul"):
        rpk = g1.scalar_mul_bits(r_bits, (pk_x, pk_y))
    with stage("msm_g2"):
        sig = (sig_x, sig_y, fp2.one((n,), dev))
        sig = g2.select(valid, sig, g2.infinity((n,), dev))
        u_planes = msm.masked_plane_sums(g2, sig, torch.flip(r_bits, (-1,)))  # LSB first
    # lanes: N (r_i·pk_i, H(m_i)) and 64 (−[2^b]g1, U_b)
    with stage("miller_loop"):
        px = torch.cat([rpk[0], fp.const(NEG_G1_POW2_64_X, dev)], 0)
        py = torch.cat([rpk[1], fp.const(NEG_G1_POW2_64_Y, dev)], 0)
        pz = torch.cat([rpk[2], fp.one((R_BITS,), dev)], 0)
        qx = torch.cat([msg_x, u_planes[0]], 0)
        qy = torch.cat([msg_y, u_planes[1]], 0)
        qz = torch.cat([fp2.one((n,), dev), u_planes[2]], 0)
        lane_ok = torch.cat([valid, ~g2.is_infinity(u_planes)], 0)
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
        fs = fp12.select(lane_ok, fs, fp12.one((n + R_BITS,), dev))
    with stage("product_tree"):
        prod = fp12.product_tree(fs)
    with stage("final_exp"):
        verdict = fp12.is_one(final_exponentiation_one(prod))
    if check_planes:
        with stage("plane_subgroup"):
            verdict = verdict & planes_in_subgroup(u_planes)
    return verdict


# --- the per-set verdicts ------------------------------------------------------

def individual_verify_kernel(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, valid):
    """Per-set verdicts e(pk_i, H(m_i))·e(−g1, sig_i) == 1 in one call:
    (N,) bool, padding lanes False. CUDA tensors run K3, the fused pairing
    (the JAX package's `LODESTAR_TPU_PALLAS_PAIRING` resolves on on a TPU;
    the port hard-codes that); CPU tensors run its plain version,
    `cuda_tower.individual_pairing_terms` + `final_exponentiation_batch`."""
    fe = cuda_tower.pairing_fused((pk_x, pk_y), (msg_x, msg_y), (sig_x, sig_y))
    return fp12.is_one(fe) & valid


def bisect_tree_kernel(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid):
    """Randomised per-set terms, every level of their product tree, and one
    final exponentiation of the root.

    Each lane contributes f_i = ML(r_i·pk_i, H_i)·ML(−g1, r_i·sig_i), whose
    final exponentiation is ε_i^{r_i} for the set's pairing error ε_i. The
    root passes when every set is valid (up to the 2⁻⁶⁴ soundness of batch
    verification); otherwise `TorchBlsVerifier._bisect` searches the
    levels. A leaf probe is exact (r_i < 2⁶⁴ < r is invertible mod r).

    Returns (root_ok 0-dim bool, levels): levels[0] (M,) leaf terms with M
    = N padded to a power of two (identity padding), levels[j] (M >> j,)
    partial products, levels[-1] (1,) the root. Lanes with `valid` False
    contribute the identity; the caller reports them False."""
    n = pk_x.shape[0]
    dev = pk_x.device
    rpk = g1.scalar_mul_bits(r_bits, (pk_x, pk_y))
    rsig = g2.scalar_mul_bits(r_bits, (sig_x, sig_y))
    gx = fp.const(G1_GEN_X, dev).expand(n, N_LIMBS)
    neg_gy = fp.neg(fp.const(G1_GEN_Y, dev)).expand(n, N_LIMBS)
    px = torch.cat([rpk[0], gx], 0)
    py = torch.cat([rpk[1], neg_gy], 0)
    pz = torch.cat([rpk[2], fp.one((n,), dev)], 0)
    qx = torch.cat([msg_x, rsig[0]], 0)
    qy = torch.cat([msg_y, rsig[1]], 0)
    qz = torch.cat([fp2.one((n,), dev), rsig[2]], 0)
    fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
    f = fp12.mul(fs[:n], fs[n:])
    f = fp12.select(valid, f, fp12.one((n,), dev))
    m = 1 << max(0, (n - 1).bit_length())
    if m > n:
        f = torch.cat([f, fp12.one((m - n,), dev)], 0)
    levels = [f]
    while f.shape[0] > 1:
        f = fp12.mul(f[0::2], f[1::2])
        levels.append(f)
    root_ok = fp12.is_one(final_exponentiation_one(levels[-1][0]))
    return root_ok, levels


def bisect_probe_kernel(fs):
    """(PROBE_LANES,) stacked tree nodes → (PROBE_LANES,) bool: is_one of
    each node's final exponentiation, the easy part's inversion shared by
    the probe. Identity padding lanes pass and are sliced off."""
    return fp12.is_one(final_exponentiation_batch(fs))


# the JAX package's standalone compile unit of the same function
final_exp_batch_kernel = bisect_probe_kernel


class TorchBlsVerifier:
    """`IBlsVerifier`-shaped verifier.

    verify_signature_sets(sets) → all-or-nothing verdict (root-grouped,
    pk-grouped, split or flat, as the planner decides);
    verify_signature_sets_individual(sets) → per-set verdicts (bisection).
    Infinity or malformed pubkeys and signatures, or failed subgroup
    checks, give False without raising. Runs on `device` (default: the
    GPU; raises without one). `grouped_configs` and `pk_grouped_configs`
    are the (rows, lanes) shapes of the two grouped verdicts (lanes a
    multiple of 4), tried smallest first. `rng` (a numpy Generator or a
    callable returning 64-bit words) replaces the CSPRNG draw of the random
    coefficients, for tests and reproducible runs. `stage_seconds`
    accumulates host time per stage (marshal, hash_to_curve, rand,
    dispatch, device_wait, bisect; hash_to_curve sums the seconds of the
    marshal pool's threads); `last_bisect` holds the rounds and probes of
    the last per-set call.

    `observer` (duck-typed, as the JAX package's `PipelineMetrics`; by
    default `NullObserver`) is called where `TpuBlsVerifier` calls its
    observer: stage timers, planner paths, h2c and pk cache events,
    device-wait and busy samples, bisection outcomes, and through the
    epoch table its events. It is called from the marshal pool's threads
    too, so it must be thread-safe, as `PipelineMetrics` is. `faults`
    (duck-typed, as the JAX package's `testing.faults`; by default none)
    is called as `on_device_dispatch(n)` before each dispatch and
    `flaky_verdict(v)` / `flaky_verdicts(vs)` on each verdict. The epoch
    pubkey table is on (the JAX package's LODESTAR_TPU_EPOCH_TABLE
    default), and so is device decompression of the signatures
    (LODESTAR_TPU_DEVICE_DECOMPRESS: `_device_decompress`, hard-coded)."""

    _device_decompress = True

    def __init__(
        self,
        device=None,
        grouped_configs: tuple[tuple[int, int], ...] = ((16, 8), (64, 64)),
        rng=None,
        pk_grouped_configs: tuple[tuple[int, int], ...] = ((128, 32),),
        observer=None,
        faults=None,
    ):
        self.device = resolve_device(device)
        self.observer = observer if observer is not None else NULL_OBSERVER
        self._faults = faults
        self.grouped_configs = tuple(sorted(grouped_configs, key=lambda c: c[0] * c[1]))
        self.pk_grouped_configs = tuple(sorted(pk_grouped_configs, key=lambda c: c[0] * c[1]))
        for _, lanes in self.grouped_configs + self.pk_grouped_configs:
            if lanes % 4 != 0:
                # the bit-plane MSMs' subset tables take lanes in fours
                raise ValueError("grouped lanes per row must be a multiple of 4")
        self._rng = rng
        self.last_bisect = {"rounds": 0, "probes": 0}
        # H(m) cache keyed by signing root (committee gossip shares roots)
        # and decompressed-pubkey cache (validators repeat every epoch):
        # bounded insertion-ordered dicts evicted FIFO, each under a lock
        self._h2c_cache: dict[bytes, tuple] = {}
        self._h2c_cache_max = H2C_CACHE_MAX
        self._h2c_lock = threading.Lock()
        self._pk_cache: dict[bytes, np.ndarray] = {}
        self._pk_cache_max = PK_CACHE_MAX
        self._pk_lock = threading.Lock()
        self.stage_seconds: dict[str, float] = {}
        self._stage_lock = threading.Lock()
        # decompressed G1 limbs of the active validator set, per epoch:
        # `_pk_rows` consults it before paying for a decompression
        self._epoch_table = EpochPubkeyTable(observer=self.observer, device=self.device)

    def _add_stage(self, name: str, dt: float) -> None:
        with self._stage_lock:  # the marshal pool's threads add hash_to_curve
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + dt

    @contextlib.contextmanager
    def _stage(self, name: str):
        """The observer's stage timer around the block, whose host seconds
        also go to `stage_seconds`."""
        t0 = time.perf_counter()
        with self.observer.stage(name):
            yield
        self._add_stage(name, time.perf_counter() - t0)

    # -- fault-injection seam --------------------------------------------------

    def _on_device_dispatch(self, n_sets: int) -> None:
        if self._faults is not None:
            self._faults.on_device_dispatch(n_sets)

    def _flaky(self, verdict: bool) -> bool:
        return verdict if self._faults is None else self._faults.flaky_verdict(verdict)

    def _flaky_all(self, verdicts: list[bool]) -> list[bool]:
        return verdicts if self._faults is None else self._faults.flaky_verdicts(verdicts)

    # -- host marshalling ---------------------------------------------------

    def _hash_root(self, key: bytes):
        """H(m) limbs for one signing root via the bounded cache; None if
        the C tier rejects it."""
        from .. import native

        with self._h2c_lock:
            hit = self._h2c_cache.get(key)
        self.observer.cache_event("h2c", hit is not None)
        if hit is None:
            with self._stage("hash_to_curve"):
                rc, limbs = native.hash_to_g2(key, DST_G2)
            if rc != 0:
                return None
            hit = (limbs[0], limbs[1])
            with self._h2c_lock:
                cache = self._h2c_cache
                while len(cache) >= self._h2c_cache_max:
                    cache.pop(next(iter(cache)))
                cache[key] = hit
        return hit

    def _pk_rows(self, sets):
        """(pk_x, pk_y) rows for every set via the pubkey cache; None if any
        pubkey is malformed or infinity. A miss looks in the epoch table,
        then pays one C-tier G1 decompression without the subgroup check,
        as the JAX path does."""
        from .. import native

        try:
            keys = [s.pubkey.to_bytes() for s in sets]
        except ValueError:
            return None
        with self._pk_lock:
            rows = [self._pk_cache.get(k) for k in keys]
        misses = {k for k, r in zip(keys, rows) if r is None}
        self.observer.cache_event("pk", True, n=len(keys) - len(misses))
        self.observer.cache_event("pk", False, n=len(misses))
        if misses:
            fresh = {}
            # the epoch table first: a hit is a copy off its host mirror
            # instead of an Fp square root
            if self._epoch_table is not None:
                miss_keys = list(misses)
                for k, row in zip(miss_keys, self._epoch_table.lookup_rows(miss_keys)):
                    if row is not None:
                        fresh[k] = row
                        misses.discard(k)
            for k in misses:
                if len(k) != 48:
                    return None
                rc, limbs = native.g1_decompress(k, check_subgroup=False)
                if rc != 0:
                    return None  # an infinity pubkey is invalid per Eth2
                fresh[k] = np.concatenate((limbs[0], limbs[1]))
            with self._pk_lock:
                cache = self._pk_cache
                for k, v in fresh.items():
                    while len(cache) >= self._pk_cache_max:
                        cache.pop(next(iter(cache)))
                    cache[k] = v
            rows = [r if r is not None else fresh[k] for k, r in zip(keys, rows)]
        packed = np.stack(rows)
        return packed[:, :N_LIMBS], packed[:, N_LIMBS:]

    # -- epoch-scoped precomputation --------------------------------------------

    def warm_h2c(self, messages) -> int:
        """Fill the hash-to-curve cache for 32-byte signing roots (the lane
        dispatcher's H(m) dedup seam: one hash per unique root of a
        coalesced flush); returns the number of roots hashed (misses)."""
        hashed = 0
        for m in messages:
            if len(m) != 32:
                continue
            with self._h2c_lock:
                hit = m in self._h2c_cache
            if not hit:
                if self._hash_root(m) is not None:
                    hashed += 1
        return hashed

    def epoch_table_populate(self, epoch: int, pubkeys) -> int:
        """Install one epoch's entry of the pubkey table from compressed
        pubkey bytes (the node calls this at the epoch transition with the
        active validator set), each decompressed once here, off the
        dispatch path, or taken from `_pk_cache`; malformed and infinity
        keys are skipped. Returns the rows installed."""
        from .. import native

        if self._epoch_table is None:
            return 0
        items = []
        for k in pubkeys:
            k = bytes(k)
            with self._pk_lock:
                row = self._pk_cache.get(k)
            if row is None:
                rc, limbs = native.g1_decompress(k, check_subgroup=False)
                if rc != 0:
                    continue
                row = np.concatenate((limbs[0], limbs[1]))
            items.append((k, row))
        return self._epoch_table.populate(epoch, items)

    def epoch_table_snapshot(self):
        """The epoch table's state (`/debug/epoch_table`)."""
        if self._epoch_table is None:
            return {"enabled": False}
        return self._epoch_table.snapshot()

    @staticmethod
    def _plan_runs(keys, configs):
        """Pack items into per-key runs of ≤ lane_cap, ≤ rows_cap runs in
        all, under the first config that fits; None when none fits or
        fewer than half the items share keys."""
        uniq = len(set(keys))
        if uniq * 2 > len(keys):
            return None
        for rows_cap, lane_cap in configs:
            if len(keys) > rows_cap * lane_cap:
                continue
            runs: list[list[int]] = []
            open_run: dict[bytes, list[int]] = {}
            fits = True
            for idx, key in enumerate(keys):
                run = open_run.get(key)
                if run is not None and len(run) < lane_cap:
                    run.append(idx)
                else:
                    run = [idx]
                    runs.append(run)
                    open_run[key] = run
                    if len(runs) > rows_cap:
                        fits = False
                        break
            if fits:
                return rows_cap, lane_cap, runs
        return None

    def _plan_groups(self, sets):
        return self._plan_runs([s.message for s in sets], self.grouped_configs)

    def _plan_pk_groups(self, sets):
        """The pk-grouped plan: pays when pubkeys repeat while roots do not
        (a flood of unique roots from a bounded set of keys); None when no
        config fits or a pubkey is malformed (the flat path reports it)."""
        try:
            keys = [s.pubkey.to_bytes() for s in sets]
        except ValueError:
            return None
        return self._plan_runs(keys, self.pk_grouped_configs)

    @staticmethod
    def _split_shared_unique(sets):
        """(indices of sets whose root another set shares, indices of the
        sets with a root of their own)."""
        freq = Counter(s.message for s in sets)
        shared = [i for i, s in enumerate(sets) if freq[s.message] >= 2]
        unique = [i for i, s in enumerate(sets) if freq[s.message] < 2]
        return shared, unique

    def _marshal_grouped(self, sets, plan):
        """Scatter sets into (rows × lanes) by signing root with the
        signatures kept as bytes → (GroupedArrays with sig_* zeroed,
        sig_raw (R, L, 96) uint8); None if any set is invalid."""
        rows_cap, lane_cap, runs = plan
        pk_rows = self._pk_rows(sets)
        if pk_rows is None:
            return None
        pk_x, pk_y = pk_rows
        sig_all = np.frombuffer(b"".join(s.signature for s in sets), np.uint8).reshape(
            len(sets), 96
        )
        sig_raw = np.zeros((rows_cap, lane_cap, 96), np.uint8)
        g = GroupedArrays(rows_cap, lane_cap)
        for row, run in enumerate(runs):
            hit = self._hash_root(sets[run[0]].message)
            if hit is None:
                return None
            g.msg_x[row], g.msg_y[row] = hit
            idx = np.asarray(run)
            k = len(run)
            g.pk_x[row, :k], g.pk_y[row, :k] = pk_x[idx], pk_y[idx]
            sig_raw[row, :k] = sig_all[idx]
            g.valid[row, :k] = True
        g.n = len(sets)
        return g, sig_raw

    def _hash_roots(self, sets) -> list:
        """H(m) limbs of every set's root (None where the C tier rejects
        one). Batches of at least two pool tasks hash through the marshal
        pool, `_MARSHAL_CHUNK` sets per task."""
        pool = _marshal_pool()
        if pool is None or len(sets) < 2 * _MARSHAL_CHUNK:
            return [self._hash_root(s.message) for s in sets]

        def chunk(lo, hi):
            return [self._hash_root(s.message) for s in sets[lo:hi]]

        bounds = list(range(0, len(sets), _MARSHAL_CHUNK)) + [len(sets)]
        futs = [pool.submit(chunk, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
        return [h for f in futs for h in f.result()]

    def _marshal_pk_grouped(self, sets, plan):
        """Scatter sets into (rows × lanes) by pubkey with the signatures
        kept as bytes → (PkGroupedArrays with sig_* zeroed, sig_raw (R, L,
        96) uint8); None if any set is invalid. The roots of this path are
        mostly unique, so they are hashed through the marshal pool."""
        rows_cap, lane_cap, runs = plan
        pk_rows = self._pk_rows(sets)
        if pk_rows is None:
            return None
        pk_x, pk_y = pk_rows
        hits = self._hash_roots(sets)
        if any(h is None for h in hits):
            return None
        hx = np.stack([h[0] for h in hits])
        hy = np.stack([h[1] for h in hits])
        sig_all = np.frombuffer(b"".join(s.signature for s in sets), np.uint8).reshape(
            len(sets), 96
        )
        sig_raw = np.zeros((rows_cap, lane_cap, 96), np.uint8)
        g = PkGroupedArrays(rows_cap, lane_cap)
        for row, run in enumerate(runs):
            idx = np.asarray(run)
            k = len(run)
            g.pk_x[row], g.pk_y[row] = pk_x[run[0]], pk_y[run[0]]
            g.msg_x[row, :k], g.msg_y[row, :k] = hx[idx], hy[idx]
            sig_raw[row, :k] = sig_all[idx]
            g.valid[row, :k] = True
        g.n = len(sets)
        return g, sig_raw

    # -- submit / resolve ---------------------------------------------------

    def verify_signature_sets(self, sets) -> bool:
        return self.verify_signature_sets_submit(sets)()

    def verify_signature_sets_submit(self, sets):
        """Marshal and dispatch now, block later: returns a zero-argument
        resolver for the verdict. The planner's order is the JAX package's:
        root-grouped, pk-grouped, split (shared roots grouped, the rest
        pk-grouped or flat), flat."""
        self._on_device_dispatch(len(sets))
        if sets and self._native_eligible(sets):
            plan = self._plan_groups(sets)
            if plan is not None:
                t = time.perf_counter()
                return self._resolver(self._submit_grouped(sets, plan), t)
            pk_plan = self._plan_pk_groups(sets)
            if pk_plan is not None:
                t = time.perf_counter()
                return self._resolver(self._submit_pk_grouped(sets, pk_plan), t)
            shared, unique = self._split_shared_unique(sets)
            if shared and unique:
                shared_sets = [sets[i] for i in shared]
                sub_plan = self._plan_groups(shared_sets)
                if sub_plan is not None:
                    # the parts also count under their own paths
                    self.observer.planner("split", len(sets))
                    t = time.perf_counter()
                    grouped = self._submit_grouped(shared_sets, sub_plan)
                    if grouped is None:
                        return lambda: False
                    unique_sets = [sets[i] for i in unique]
                    pk_plan = self._plan_pk_groups(unique_sets)
                    if pk_plan is not None:
                        rest = self._resolver(self._submit_pk_grouped(unique_sets, pk_plan), t)
                    else:
                        rest = self._submit_flat(unique_sets)
                    return lambda: self._resolve(grouped, t) and rest()
        return self._submit_flat(sets)

    def _resolver(self, result, t_submit: float):
        """The resolver of one dispatch; None (an invalid set) is False."""
        if result is None:
            return lambda: False
        return lambda: self._resolve(result, t_submit)

    def _submit_grouped(self, sets, plan):
        """Dispatch one root-grouped batch; None marks an invalid set."""
        self.observer.planner("root_grouped", len(sets), group_sizes=[len(r) for r in plan[2]])
        return self._submit_rows(sets, plan, self._marshal_grouped, grouped_verify_kernel_raw)

    def _submit_pk_grouped(self, sets, plan):
        """Dispatch one pk-grouped batch; None marks an invalid set."""
        self.observer.planner("pk_grouped", len(sets), group_sizes=[len(r) for r in plan[2]])
        return self._submit_rows(sets, plan, self._marshal_pk_grouped,
                                 pk_grouped_verify_kernel_raw)

    def _submit_rows(self, sets, plan, marshal, kernel):
        """Marshal a (rows × lanes) plan, draw its GLS bits and dispatch
        `kernel` on the raw signatures; None marks an invalid set."""
        with self._stage("marshal"):
            marshalled = marshal(sets, plan)
        if marshalled is None:
            return None
        g, sig_raw = marshalled
        with self._stage("rand"):
            a_bits, b_bits = _rand_pairs(g.valid.shape, self._rng)
        dev = self.device
        with self._stage("dispatch"):
            return kernel(
                *(torch.as_tensor(x).to(dev) for x in (g.pk_x, g.pk_y, g.msg_x, g.msg_y)),
                torch.as_tensor(sig_raw).to(dev),
                torch.as_tensor(a_bits).to(dev),
                torch.as_tensor(b_bits).to(dev),
                torch.as_tensor(g.valid).to(dev),
            )

    def _submit_flat(self, sets):
        """The flat verdict in chunks of the largest bucket; the resolver
        ANDs the chunks' verdicts (all or nothing, as one dispatch). Sets
        in the 32 B root / 96 B signature shape keep their signatures as
        bytes for the device; others are decoded on the host."""
        if sets:
            self.observer.planner("per_set", len(sets))
        cap = BUCKETS[-1]
        raw = self._native_eligible(sets)
        results = []
        dev = self.device
        t_submit = time.perf_counter()
        for lo in range(0, max(len(sets), 1), cap):
            chunk = sets[lo: lo + cap]
            with self._stage("marshal"):
                marshalled = self._marshal(chunk, raw=raw)
            if marshalled is None:
                return lambda: False
            arrs, sig_raw = marshalled if raw else (marshalled, None)
            with self._stage("rand"):
                r_bits = torch.as_tensor(_rand_bits(arrs.pk_x.shape[0], self._rng)).to(dev)
            with self._stage("dispatch"):
                t = self._tensors(arrs)
                if raw:
                    results.append(batch_verify_kernel_raw(
                        *t[:4], torch.as_tensor(sig_raw).to(dev), r_bits, t[6]))
                else:
                    results.append(batch_verify_kernel(*t[:6], r_bits, t[6]))
        return lambda: all(self._resolve(r, t_submit) for r in results)

    def _resolve(self, result, t_submit: float) -> bool:
        """Block on one device verdict: the wait is the `device_wait` stage,
        and the busy sampler gets the whole span from submit to resolve
        (the device computes through the gap)."""
        t0 = time.perf_counter()
        verdict = bool(result)
        now = time.perf_counter()
        self.observer.observe_stage("device_wait", now - t0)
        self.observer.device_busy_sample(now - t_submit)
        self._add_stage("device_wait", now - t0)
        return self._flaky(verdict)

    # -- per-set verdicts ---------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in BUCKETS:
            if n <= b:
                return b
        return BUCKETS[-1]

    def _native_eligible(self, sets) -> bool:
        return all(len(s.message) == 32 and len(s.signature) == 96 for s in sets)

    def _native_limbs(self, sets):
        """Per-set (pk_x, pk_y, sig_x, sig_y) limbs through the C tier:
        pubkeys from the cache (`_pk_rows`), signatures decompressed and
        subgroup-checked; None if any set is malformed, out of the
        subgroup or at infinity."""
        from .. import native

        pk_rows = self._pk_rows(sets)
        if pk_rows is None:
            return None
        n = len(sets)
        # do_pk=False and do_hash=False: the pubkey and message bytes are
        # not read, the caches fill those arrays
        _, _, _, _, sig_x, sig_y, ok = native.bls_marshal_sets(
            bytes(48 * n), bytes(32 * n), b"".join(s.signature for s in sets), DST_G2,
            do_hash=False, do_pk=False,
        )
        if not ok.all():
            return None
        return pk_rows[0], pk_rows[1], sig_x, sig_y

    def _marshal(self, sets, raw: bool = False):
        """Padded limb arrays for one bucket (`SetArrays`); None if there are
        no sets, more than the largest bucket, or any invalid set. With
        raw=True the signatures stay bytes for the device to decode →
        (SetArrays with sig_* zeroed, sig_raw (lanes, 96) uint8); the
        caller has checked the 96 B signature shape."""
        if not sets:
            return None
        lanes = self.bucket_for(len(sets))
        if len(sets) > lanes:
            return None  # the caller chunks
        n = len(sets)
        arrs = SetArrays(lanes)
        if raw:
            pk_rows = self._pk_rows(sets)
            if pk_rows is None:
                return None
            arrs.pk_x[:n], arrs.pk_y[:n] = pk_rows
            sig_raw = np.zeros((lanes, 96), np.uint8)
            sig_raw[:n] = np.frombuffer(b"".join(s.signature for s in sets), np.uint8).reshape(
                n, 96
            )
        else:
            # the JAX package decodes a batch outside the root / signature
            # shape with its Python oracle; the port has none and needs
            # none: any message length is hashed by the C tier as a root
            # is, and a signature that is not 96 bytes is malformed
            if any(len(s.signature) != 96 for s in sets):
                return None
            limbs = self._native_limbs(sets)
            if limbs is None:
                return None
            arrs.pk_x[:n], arrs.pk_y[:n], arrs.sig_x[:n], arrs.sig_y[:n] = limbs
        for i, s in enumerate(sets):
            hit = self._hash_root(s.message)
            if hit is None:
                return None
            arrs.msg_x[i], arrs.msg_y[i] = hit
        arrs.valid[:n] = True
        arrs.n = n
        return (arrs, sig_raw) if raw else arrs

    def _tensors(self, arrs: SetArrays) -> tuple:
        dev = self.device
        return tuple(
            torch.as_tensor(x).to(dev)
            for x in (arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y,
                      arrs.sig_x, arrs.sig_y, arrs.valid)
        )

    def verify_individual(self, arrs: SetArrays) -> torch.Tensor:
        """Exact per-set verdicts of a marshalled bucket, (lanes,) bool on
        the device: one K3 launch on the GPU."""
        return individual_verify_kernel(*self._tensors(arrs))

    def verify_bisect_tree(self, arrs: SetArrays, r_bits: np.ndarray):
        """(root_ok, product-tree levels) of a marshalled bucket."""
        t = self._tensors(arrs)
        return bisect_tree_kernel(*t[:6], torch.as_tensor(r_bits).to(self.device), t[6])

    def probe_nodes(self, fs: torch.Tensor) -> torch.Tensor:
        """(PROBE_LANES,) stacked tree nodes → (PROBE_LANES,) bool."""
        return bisect_probe_kernel(fs)

    def miller_kernel(self, p_aff, q_aff) -> torch.Tensor:
        """The affine Miller loop on (xp, yp), (xq, yq) limb arrays: K2 on
        the GPU."""
        dev = self.device
        return cuda_tower.miller_loop_kernel(
            tuple(torch.as_tensor(x).to(dev) for x in p_aff),
            tuple(torch.as_tensor(x).to(dev) for x in q_aff),
        )

    def pairing_kernel(self, arrs: SetArrays) -> torch.Tensor:
        """Per-set verdicts through the fused pairing: K3 on the GPU."""
        return self.verify_individual(arrs)

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        """Per-set verdicts by bisection: one randomised product tree whose
        root's final exponentiation decides the all-valid case; on failure
        `_bisect` finds the invalid sets with O(k·log N) probe final
        exponentiations. Leaf probes are exact, so the verdicts are those of
        `individual_verify_kernel` and of the host C tier. A batch that
        does not marshal (a malformed set, or more sets than the largest
        bucket) is verified one set at a time (`_verify_one`)."""
        self.observer.planner("individual", len(sets))
        self._on_device_dispatch(len(sets))
        with self._stage("marshal"):
            arrs = self._marshal(sets)
        if arrs is None:
            # as the reference does: each set on its own, malformed ones False
            return [self._verify_one(s) for s in sets]
        with self._stage("rand"):
            r_bits = _rand_bits(arrs.pk_x.shape[0], self._rng)
        t = time.perf_counter()
        with self._stage("dispatch"):
            root_ok, levels = self.verify_bisect_tree(arrs, r_bits)
        with self._stage("device_wait"):
            root_ok = bool(root_ok)
        self.observer.device_busy_sample(time.perf_counter() - t)
        if root_ok:
            self.last_bisect = {"rounds": 0, "probes": 0}
            self.observer.bisect(rounds=0, probes=0)
            return self._flaky_all([True] * arrs.n)
        verdicts = self._bisect(arrs, levels)
        return self._flaky_all([bool(v) for v in verdicts[: arrs.n]])

    def _bisect(self, arrs: SetArrays, levels) -> np.ndarray:
        """Binary-search a failed product tree for the invalid leaves.

        levels[j] holds M >> j nodes; node (j, i) covers leaves
        [i·2^j, (i+1)·2^j). Each round probes the children of the nodes
        that failed, PROBE_LANES at a time (identity padding); a child that
        passes clears its subtree, and the failed level-0 nodes are the
        invalid sets. A failed parent whose children all pass (a 2⁻⁶⁴
        cancellation) falls back to the exact per-set kernel."""
        m = levels[0].shape[0]
        verdicts = np.ones(m, bool)
        verdicts[arrs.n:] = False  # padding lanes report False
        frontier = [(len(levels) - 1, 0)]
        rounds = probes = 0
        while frontier:
            if frontier[0][0] == 0:
                for _, i in frontier:
                    verdicts[i] = False
                break
            rounds += 1
            children = [(lvl - 1, 2 * i + k) for lvl, i in frontier for k in (0, 1)]
            failed = []
            for lo in range(0, len(children), PROBE_LANES):
                chunk = children[lo: lo + PROBE_LANES]
                t0 = time.perf_counter()
                with self._stage("bisect"):
                    batch = torch.stack([levels[lvl][i] for lvl, i in chunk])
                    if len(chunk) < PROBE_LANES:
                        pad = fp12.one((PROBE_LANES - len(chunk),), batch.device)
                        batch = torch.cat([batch, pad], 0)
                    out = self.probe_nodes(batch).cpu().numpy()
                self.observer.device_busy_sample(time.perf_counter() - t0)
                probes += len(chunk)
                failed.extend(node for node, ok in zip(chunk, out[: len(chunk)]) if not ok)
            if not failed:
                self.last_bisect = {"rounds": rounds, "probes": probes}
                self.observer.bisect(rounds=rounds, probes=probes)
                return self.verify_individual(arrs).cpu().numpy()
            frontier = failed
        self.last_bisect = {"rounds": rounds, "probes": probes}
        self.observer.bisect(rounds=rounds, probes=probes)
        return verdicts

    def _verify_one(self, s) -> bool:
        try:
            arrs = self._marshal([s])
        except ValueError:
            return False
        if arrs is None:
            return False
        return bool(self.verify_individual(arrs)[0])
