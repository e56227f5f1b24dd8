"""Root-grouped batch verification of BLS signature sets.

The port of the JAX package's gossip-attestation verdict
(`parallel/verifier.py`: `TpuBlsVerifier.verify_signature_sets` →
`_plan_groups` → `_submit_grouped` → `_marshal_grouped(raw=True)` →
`grouped_verify_kernel_raw`). Sets that share a signing root are grouped
into R rows × L lanes and checked with ONE random linear combination,

    Π_j e(Σ_{i∈j} r_i·pk_i, H_j) · e(−g1, Σ_i r_i·sig_i) == 1,

with r_i = a_i + z·b_i (a, b uniform 32-bit; the GLS split), bit-plane
MSMs for both sums, 2R + 64 projective Miller lanes, one Fp12 product, one
final exponentiation and the batched plane subgroup check of the
signatures, which stay compressed wire bytes until the device decodes
them. The verdict is one bit, all or nothing.

The other verdict paths of the JAX package (pk-grouped, split, flat,
bisection, per-set) are not ported yet: a batch the grouped planner
refuses raises NotImplementedError instead of answering on the CPU.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
import time

import numpy as np
import torch

from ..bls.api import DST_G2
from ..device import resolve_device
from ..ops import fp, fp2, fp12, msm
from ..ops.g2_decompress import decompress, planes_in_subgroup
from ..ops.pairing import final_exponentiation_one, miller_loop_proj_pq
from ..ops.points import NEG_G1_POW2_X, NEG_G1_POW2_Y, g1, g2, g2_psi

N_LIMBS = 32
HALF_BITS = 32  # the a/b halves of the r = a + z·b split
H2C_CACHE_MAX = 8192
# the JAX package reads LODESTAR_TPU_PK_CACHE_MAX (default 2^21, every
# active mainnet validator); the port keeps the default
PK_CACHE_MAX = 1 << 21

__all__ = [
    "GroupedArrays",
    "TorchBlsVerifier",
    "grouped_verify_kernel",
    "grouped_verify_kernel_raw",
]


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


class TorchBlsVerifier:
    """`IBlsVerifier`-shaped batch verifier on the root-grouped path.

    verify_signature_sets(sets) → all-or-nothing verdict. Infinity or
    malformed pubkeys and signatures, or failed subgroup checks, give
    False without raising. Runs on `device` (default: the GPU; raises
    without one). `stage_seconds` accumulates host time per stage
    (marshal, hash_to_curve, rand, dispatch, device_wait)."""

    def __init__(
        self,
        device=None,
        grouped_configs: tuple[tuple[int, int], ...] = ((16, 8), (64, 64)),
        rng=None,
    ):
        self.device = resolve_device(device)
        self.grouped_configs = tuple(grouped_configs)
        self._rng = rng
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

    def _stage(self, name: str, t0: float) -> None:
        self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + time.perf_counter() - t0

    # -- host marshalling ---------------------------------------------------

    def _hash_root(self, key: bytes):
        """H(m) limbs for one signing root via the bounded cache; None if
        the C tier rejects it."""
        from .. import native

        with self._h2c_lock:
            hit = self._h2c_cache.get(key)
        if hit is None:
            t0 = time.perf_counter()
            rc, limbs = native.hash_to_g2(key, DST_G2)
            self._stage("hash_to_curve", t0)
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
        pubkey is malformed or infinity. A miss pays one C-tier G1
        decompression without the subgroup check, as the JAX path does."""
        from .. import native

        try:
            keys = [s.pubkey.to_bytes() for s in sets]
        except ValueError:
            return None
        with self._pk_lock:
            rows = [self._pk_cache.get(k) for k in keys]
        misses = {k for k, r in zip(keys, rows) if r is None}
        if misses:
            fresh = {}
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

    # -- submit / resolve ---------------------------------------------------

    def verify_signature_sets(self, sets) -> bool:
        return self.verify_signature_sets_submit(sets)()

    def verify_signature_sets_submit(self, sets):
        """Marshal and dispatch now, block later: returns a zero-argument
        resolver for the verdict."""
        if not sets:
            return lambda: False  # the JAX package answers False, unbatched
        if not all(len(s.message) == 32 and len(s.signature) == 96 for s in sets):
            raise NotImplementedError(
                "sets outside the 32 B root / 96 B signature shape take the "
                "flat verdict path, which is not ported yet (ROADMAP Queue 1)"
            )
        plan = self._plan_groups(sets)
        if plan is None:
            raise NotImplementedError(
                "the grouped planner refused this batch; the pk-grouped, split "
                "and flat verdict paths are not ported yet (ROADMAP Queue 1)"
            )
        result = self._submit_grouped(sets, plan)
        if result is None:
            return lambda: False
        return lambda: self._resolve(result)

    def _submit_grouped(self, sets, plan):
        """Dispatch one grouped batch; None marks an invalid set."""
        t0 = time.perf_counter()
        marshalled = self._marshal_grouped(sets, plan)
        self._stage("marshal", t0)
        if marshalled is None:
            return None
        g, sig_raw = marshalled
        t0 = time.perf_counter()
        a_bits, b_bits = _rand_pairs(g.valid.shape, self._rng)
        self._stage("rand", t0)
        t0 = time.perf_counter()
        dev = self.device
        result = grouped_verify_kernel_raw(
            *(torch.as_tensor(x).to(dev) for x in (g.pk_x, g.pk_y, g.msg_x, g.msg_y)),
            torch.as_tensor(sig_raw).to(dev),
            torch.as_tensor(a_bits).to(dev),
            torch.as_tensor(b_bits).to(dev),
            torch.as_tensor(g.valid).to(dev),
        )
        self._stage("dispatch", t0)
        return result

    def _resolve(self, result) -> bool:
        t0 = time.perf_counter()
        verdict = bool(result)
        self._stage("device_wait", t0)
        return verdict
