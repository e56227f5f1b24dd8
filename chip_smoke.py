"""Smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. env    the card's name and power limit, the torch and CUDA versions.
2. build  K1 (`csrc/mont_mul.cu`), K2/K3 (`csrc/tower.cu`), both with nvcc
          for sm_90a, the C host tier (`csrc/host/`, cc) and the K2/K3 host
          harness (`csrc/tower_host.cpp`, c++) from the checkout, all at
          once, into build/lodestar_tpu_torch/; ptxas's registers, stack
          and spills of every kernel.
3. k1     K1 against its plain PyTorch version on the card, limb for limb
          (tolerance 0), on random values in [0, 2p) plus the edges 0, 1,
          p−1, p and 2p−1, at the lane counts the main path uses; then
          CUDA-event timings of both beside the byte bound.
4. k2     K2, the affine Miller loop, against `miller_loop_plain` on G1
          pubkeys and H(m) points made with the host tier plus one all-zero
          lane, at 8 and 256 lanes (the 2 × 128 Miller lanes of a 128-set
          per-set batch): equal canonical values (tolerance 0), CUDA-event
          times of both, the operation bound (Fp multiplies per lane counted
          by the host harness); the device memory that K2's first launch
          takes for the raised per-thread stack limit.
5. k3     K3, the fused per-set pairing, against `pairing_fused_plain` on 4
          and 128 marshalled sets with three invalid sets and one zero lane:
          equal canonical values, verdicts equal to the host tier's, times,
          bound and first-launch memory as for K2.
6. slice  4096 signature sets over 64 signing roots (one slot of mainnet
          attestation gossip) made from a fixed seed with the host tier,
          verified by `TorchBlsVerifier` at the (64, 64) configuration:
          True on the valid batch, False on four tampered ones, each equal
          to the host tier's CPU verdict; the same for 128 sets over 16
          roots, the (16, 8) configuration. K1's launch count is reset just
          before the timed main-path verdict and read just after.
7. per-set  128 sets over 128 signing roots (a block's attestations),
          `verify_signature_sets_individual` on the card: (a) the valid
          batch, all True by the root alone; (b) three tampered sets,
          found by bisection; (c) `verify_individual` on the tampered
          bucket, one K3 launch; (d) 16 sets with one bad encoding, one
          set at a time (`_verify_one`). Every list equals the host tier's
          per-set verdicts; launch counts are reset just before each call
          and read just after.
8. pairing-check  `pairing.pairing_check`, the multi-pairing primitive, over
          the 2 × 128 affine pairs of the valid and of the tampered batch:
          the path that runs K2 (one launch per check).
9. the `kernels` line, the card line, and the last line
          {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261017
THREADS = os.cpu_count() or 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_OPS_PER_S = 67e12  # the published non-tensor float32 peak, no int32 entry


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env(torch):
    log("[env] card:", card_line())
    log("[env] torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0], "host threads", THREADS)


def phase_build():
    """Build every library at once; returns ptxas's figures per kernel."""
    from lodestar_tpu_torch import build

    t0 = time.perf_counter()
    builds = (build.mont_mul_cuda, build.tower_cuda, build.host_tier, build.tower_host)
    with ThreadPoolExecutor(len(builds)) as pool:
        for job in [pool.submit(b) for b in builds]:
            job.result()
    log(f"[build] K1, K2/K3, host tier and tower host harness built in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, (secs, text) in sorted(build.BUILD_LOG.items()):
        log(f"[build] {name}: {secs:.1f} s")
        funcs = build.ptxas_summary(text)
        for fn, figs in sorted(funcs.items()):
            if figs.get("entry"):
                ptxas[fn] = figs
                log(f"[build]   kernel {fn}: {json.dumps(figs)}")
        calls = [f for f in funcs.values() if not f.get("entry")]
        if calls:
            log(f"[build]   {len(calls)} device functions: largest stack frame "
                f"{max(f.get('stack', 0) for f in calls)} B, spill stores "
                f"{sum(f.get('spill_stores', 0) for f in calls)} B, spill loads "
                f"{sum(f.get('spill_loads', 0) for f in calls)} B")
    return ptxas


def _random_limbs(rng, n: int):
    """(n, 32) int32 limbs in [0, 2p): half below 2^381 (< 2p), half
    p + v with v < 2^380 (in [p, 2p)), and the five edge values first."""
    import numpy as np

    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import P_LIMBS, int_to_limbs

    limbs = rng.integers(0, 4096, size=(n, 32), dtype=np.int64)
    limbs[:, 31] = rng.integers(0, 512, size=n)
    high = np.arange(n) % 2 == 1
    limbs[high, 31] = rng.integers(0, 256, size=int(high.sum()))
    carry = np.zeros(int(high.sum()), np.int64)
    for i in range(32):  # v + p for the [p, 2p) half
        s = limbs[high, i] + P_LIMBS[i] + carry
        limbs[high, i] = s & 4095
        carry = s >> 12
    edges = [0, 1, P - 1, P, 2 * P - 1]
    for i, v in enumerate(edges[:n]):
        limbs[i] = int_to_limbs(v)
    return limbs.astype(np.int32)


def _time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_k1(torch, np):
    from lodestar_tpu_torch.ops import cuda_fp

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    sizes = (1, 68, 4096, 64 * 4096)
    max_err = 0
    rows = []
    for n in sizes:
        a = torch.as_tensor(_random_limbs(rng, n)).to(dev)
        b = torch.as_tensor(_random_limbs(rng, n)[::-1].copy()).to(dev)
        got = cuda_fp.mont_mul_cuda(a, b)
        want = cuda_fp.mont_mul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K1 differs from its plain version at {n} lanes")
        iters = 200 if n <= 4096 else 50
        ms = _time_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        plain_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_plain(a, b), max(5, iters // 10))
        bytes_ms = 384 * n / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * 12 * 12 * 2 * n / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows.append(dict(lanes=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / ms))
        log(f"[k1] lanes={n} match=exact ms={ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f}")
    return max_err, rows


def _tampered(sets, per_root: int):
    """The four tampered batches; each keeps the multiset of roots (so
    the grouped planner keeps its layout) and names the sets it changed."""
    from lodestar_tpu_torch.bls.api import SignatureSet
    from lodestar_tpu_torch.bls.fields import P

    i, j = 3, 3 + per_root  # sets of two different roots
    out = []
    s = list(sets)  # wrong message: sets i and j trade signing roots
    s[i] = SignatureSet(sets[i].pubkey, sets[j].message, sets[i].signature)
    s[j] = SignatureSet(sets[j].pubkey, sets[i].message, sets[j].signature)
    out.append(("wrong_message", s, (i, j)))
    s = list(sets)  # one signature swapped with another set's
    s[i] = SignatureSet(sets[i].pubkey, sets[i].message, sets[j].signature)
    s[j] = SignatureSet(sets[j].pubkey, sets[j].message, sets[i].signature)
    out.append(("swapped_signature", s, (i, j)))
    s = list(sets)  # one pubkey swapped
    s[i] = SignatureSet(sets[j].pubkey, sets[i].message, sets[i].signature)
    s[j] = SignatureSet(sets[i].pubkey, sets[j].message, sets[j].signature)
    out.append(("swapped_pubkey", s, (i, j)))
    s = list(sets)  # bad encoding: x.c1 = p (x >= p) under valid flags
    bad = bytearray(sets[i].signature)
    bad[:48] = P.to_bytes(48, "big")
    bad[0] |= 0x80 | (sets[i].signature[0] & 0x20)
    s[i] = SignatureSet(sets[i].pubkey, sets[i].message, bytes(bad))
    out.append(("bad_encoding", s, (i,)))
    return out


def _host_verdicts(sets):
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.bls.api import DST_G2

    return native.verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), DST_G2, threads=THREADS,
    )


def phase_slice(torch, np, n_roots: int, per_root: int):
    """Drive TorchBlsVerifier on one batch shape; returns K1 launches of
    the main-path verdict and its wall time."""
    from lodestar_tpu_torch.ops import cuda_fp
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.profile_verdict import make_sets

    tag = f"[slice {n_roots}x{per_root}]"
    t0 = time.perf_counter()
    sets = make_sets(n_roots, per_root, seed=SEED + n_roots, threads=THREADS)
    log(f"{tag} made {len(sets)} sets in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    per_set = _host_verdicts(sets)
    host_valid = all(per_set)
    log(f"{tag} host tier verdict {host_valid} in {time.perf_counter() - t0:.1f} s")
    if not host_valid:
        raise AssertionError("the host tier rejects the valid batch")

    v = TorchBlsVerifier(device="cuda", grouped_configs=((16, 8), (64, 64)),
                         rng=np.random.default_rng(SEED))
    t0 = time.perf_counter()
    cold = v.verify_signature_sets(sets)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_stages = dict(v.stage_seconds)
    log(f"{tag} cold verdict {cold} in {cold_s:.3f} s; stages {json.dumps(cold_stages)}")
    if cold is not True:
        raise AssertionError("the port rejects the valid batch")

    # main path, warm caches: counts reset just before, read just after
    v.stage_seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    cuda_fp.LAUNCHES = 0
    t0 = time.perf_counter()
    verdict = v.verify_signature_sets(sets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_fp.LAUNCHES
    stages = dict(v.stage_seconds)
    if verdict is not True:
        raise AssertionError("the port rejects the valid batch (warm)")
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    host_s = stages.get("marshal", 0.0) + stages.get("rand", 0.0)
    log(f"{tag} warm verdict True in {wall:.3f} s = {len(sets) / wall:.1f} sets/s; "
        f"K1 launches {launches}; host marshal+rand share {host_s / wall:.6f} "
        f"(hash-to-curve {stages.get('hash_to_curve', 0.0):.6f} s); "
        f"stages {json.dumps(stages)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for name, bad, changed in _tampered(sets, per_root):
        # the host tier's batch verdict is the AND of its per-set verdicts:
        # unchanged sets keep theirs, the changed ones are verified anew
        host = list(per_set)
        fresh = _host_verdicts([bad[k] for k in changed])
        for k, ok in zip(changed, fresh):
            host[k] = ok
        want = all(host)
        t0 = time.perf_counter()
        got = v.verify_signature_sets(bad)
        secs = time.perf_counter() - t0
        log(f"{tag} {name}: port {got}, host tier {want} ({secs:.3f} s)")
        if got is not False or want is not False:
            raise AssertionError(f"{name}: the tampered batch was not rejected by both")
    return launches, wall, len(sets)


# K4 (ops/pallas_mxu.py::_mxu_kernel, not ported yet) computes K1's function
# on the matrix unit: per product a (3, 1024) @ (1024, 64) column-select
# product of 8-bit parts, then (2, 32) @ (32, 64) for m and (2, 32) @ (32, 128)
# for m·p, as 8-bit multiply-adds
K4_MACS_PER_PRODUCT = 3 * 1024 * 64 + 2 * 32 * 64 + 2 * 32 * 128
INT8_MMA_OPS_PER_S = 1979e12  # dense int8 tensor-core peak


def k4_bound(lanes: int):
    """K4's bound at `lanes` products from its shapes: (bound_ms, bound_by,
    ops_ms, bytes_ms)."""
    ops_ms = 2 * K4_MACS_PER_PRODUCT * lanes / INT8_MMA_OPS_PER_S * 1e3
    bytes_ms = 384 * lanes / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


PER_SET_N = 128  # the largest per-set bucket: a block's attestations
K2_LANES = (8, 2 * PER_SET_N)  # 2 × 128: the Miller lanes of a 128-set batch


OPS_PER_FP_MUL = 576  # int32 operations per Fp multiply: 2·12² products, each a mul.lo and a mul.hi
K2_BYTES_PER_LANE = 4 * (32 + 32 + 64 + 64 + 384)  # xp, yp, xq, yq in; the Fp12 out
K3_BYTES_PER_SET = 4 * (32 + 32 + 4 * 64 + 384)  # pk, H(m), sig in; the Fp12 out


def _bound(fp_muls_per_lane: int, bytes_per_lane: int, lanes: int):
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    ops_ms = fp_muls_per_lane * OPS_PER_FP_MUL * lanes / INT32_OPS_PER_S * 1e3
    bytes_ms = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _event_ms(torch, fn, iters: int = 1) -> float:
    """CUDA-event milliseconds per call of `fn`, already warm."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_bytes_taken(torch, fn):
    """(fn(), device bytes that the call took outside PyTorch's allocator).
    Around a tower kernel's first launch this is the local memory that the
    raised per-thread stack limit reserves for every resident thread (and
    the module's code, a few hundred KB)."""
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    free1, reserved1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    return out, (free0 - free1) - (reserved1 - reserved0)


def _canonical_err(torch, got, want) -> int:
    """Largest limb difference between a kernel's canonical output and the
    canonical form of the plain version's lazy one."""
    from lodestar_tpu_torch.ops import fp

    return int((got.long() - fp.canonical(want).long()).abs().max())


def _miller_inputs(np, n: int, seed: int):
    """n affine Miller lanes: G1 pubkeys and H(m) points from the host tier,
    lane 0 all zero."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.bls.api import DST_G2

    rng = np.random.default_rng(seed)
    sks = [(int.from_bytes(rng.bytes(31), "big") + 1).to_bytes(32, "big") for _ in range(n)]
    msgs = [rng.bytes(32) for _ in range(n)]

    def one(i):
        rc1, pk = native.sk_to_pk(sks[i])
        rc2, p = native.g1_decompress(pk)
        rc3, q = native.hash_to_g2(msgs[i], DST_G2)
        if rc1 or rc2 or rc3:
            raise RuntimeError("host tier failed to make a Miller lane")
        return p, q

    with ThreadPoolExecutor(THREADS) as pool:
        pts = list(pool.map(one, range(n)))
    xp = np.stack([p[0] for p, _ in pts])
    yp = np.stack([p[1] for p, _ in pts])
    xq = np.stack([q[0] for _, q in pts])
    yq = np.stack([q[1] for _, q in pts])
    for a in (xp, yp, xq, yq):
        a[0] = 0
    return xp, yp, xq, yq


def phase_k2(torch, np, muls: int):
    from lodestar_tpu_torch.ops import cuda_tower

    dev = torch.device("cuda")
    max_err = 0
    row = None
    stack_bytes = None
    for n in K2_LANES:
        args = [torch.as_tensor(a).to(dev) for a in _miller_inputs(np, n, SEED + n)]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.miller_loop_cuda(*args))
        if stack_bytes is None:
            stack_bytes = taken
            log(f"[k2] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB): the per-thread stack limit raised for K2")
        want = cuda_tower.miller_loop_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K2 differs from its plain version at {n} lanes")
        ms = _event_ms(torch, lambda: cuda_tower.miller_loop_cuda(*args), 5)
        plain_ms = _event_ms(torch, lambda: cuda_tower.miller_loop_plain(*args))
        bound_ms, bound_by = _bound(muls, K2_BYTES_PER_LANE, n)
        row = dict(lanes=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   stack_bytes=stack_bytes)
        log(f"[k2] lanes={n} match=canonical ms={ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f}")
    return max_err, row


def _tamper_one(sets, k: int, field: str, donor: int):
    """A copy of `sets` with set k's `field` taken from set `donor`."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    parts = {"pubkey": sets[k].pubkey, "message": sets[k].message,
             "signature": sets[k].signature}
    parts[field] = getattr(sets[donor], field)
    out[k] = SignatureSet(parts["pubkey"], parts["message"], parts["signature"])
    return out


def per_set_tamper(n: int):
    """The tampered positions of an n-set batch and what each takes from
    the set before it."""
    return ((5, "message"), (n // 2, "signature"), (n - 1, "pubkey"))


def per_set_batches(np):
    """PER_SET_N sets over as many signing roots and the same with three
    sets tampered (a wrong message, another set's signature, another set's
    pubkey), with the host tier's per-set verdicts of both."""
    from lodestar_tpu_torch.profile_verdict import make_sets

    sets = make_sets(PER_SET_N, 1, seed=SEED + 7, threads=THREADS)
    bad = sets
    for k, field in per_set_tamper(PER_SET_N):
        bad = _tamper_one(bad, k, field, k - 1)
    return sets, _host_verdicts(sets), bad, _host_verdicts(bad)


def phase_k3(torch, np, muls: int, bad, host_bad):
    from lodestar_tpu_torch.ops import cuda_tower, fp12
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    arrs = TorchBlsVerifier(device="cpu")._marshal(bad)
    if arrs is None:
        raise AssertionError("the tampered per-set batch did not marshal")
    dev = torch.device("cuda")
    zero = 3  # one all-zero lane beside the three tampered sets
    names = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")
    cols = {k: getattr(arrs, k).copy() for k in names}
    for a in cols.values():
        a[zero] = 0
    want_ok = np.array(host_bad, bool)
    want_ok[zero] = False
    max_err = 0
    row = None
    stack_bytes = None
    for lanes in (slice(3, 7), slice(0, PER_SET_N)):
        args = [torch.as_tensor(cols[k][lanes]).to(dev) for k in names]
        n = args[0].shape[0]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.pairing_fused_cuda(*args))
        if stack_bytes is None:
            stack_bytes = taken
            log(f"[k3] first launch took {taken} B more device memory "
                f"({taken / 2**20:.1f} MiB): the stack limit raised from K2's to K3's")
        want = cuda_tower.pairing_fused_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K3 differs from its plain version at {n} sets")
        ok = fp12.is_one(got).cpu().numpy()
        if not (ok == want_ok[lanes]).all():
            raise AssertionError(f"K3's verdicts differ from the host tier's at {n} sets")
        ms = _event_ms(torch, lambda: cuda_tower.pairing_fused_cuda(*args), 5)
        plain_ms = _event_ms(torch, lambda: cuda_tower.pairing_fused_plain(*args))
        bound_ms, bound_by = _bound(muls, K3_BYTES_PER_SET, n)
        row = dict(sets=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   stack_bytes=stack_bytes)
        log(f"[k3] sets={n} match=canonical verdicts=host_tier invalid={int((~ok).sum())} "
            f"ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.6f}")
    return max_err, row


def _counts():
    from lodestar_tpu_torch.ops import cuda_fp, cuda_tower

    return {"K1": cuda_fp.LAUNCHES, "K2": cuda_tower.MILLER_LAUNCHES,
            "K3": cuda_tower.PAIRING_LAUNCHES}


def _reset_counts():
    from lodestar_tpu_torch.ops import cuda_fp, cuda_tower

    cuda_fp.LAUNCHES = 0
    cuda_tower.MILLER_LAUNCHES = 0
    cuda_tower.PAIRING_LAUNCHES = 0


def _run_counted(torch, fn, verifier=None):
    """fn() with every launch count (and the verifier's stage clock) set to
    0 just before and read just after; returns (result, seconds, counts)."""
    torch.cuda.synchronize()
    if verifier is not None:
        verifier.stage_seconds.clear()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts()


def _need(counts: dict, route: str, *kernels):
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{route}: the route launched {k} no time")


def phase_per_set(torch, np, sets, host_ok, bad, host_bad):
    """The per-set verdict path on the card; returns its launch counts and
    wall times by route."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[per-set]"
    v = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED))
    out = {}

    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(sets), v)
    if got != host_ok or not all(got):
        raise AssertionError("(a) the valid batch's per-set verdicts differ from the host tier's")
    _need(counts, "(a) bisection, valid", "K1")
    if counts["K3"] != 0:
        raise AssertionError("(a) the root passed, yet K3 was launched")
    out["a"] = dict(seconds=secs, counts=counts, **v.last_bisect)
    log(f"{tag} (a) {PER_SET_N} valid sets: all True in {secs:.3f} s (first call); "
        f"launches {json.dumps(counts)}; rounds {v.last_bisect['rounds']}; "
        f"stages {json.dumps(v.stage_seconds)}")

    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(bad), v)
    if got != host_bad:
        raise AssertionError("(b) the tampered batch's per-set verdicts differ from the host tier's")
    _need(counts, "(b) bisection, three invalid", "K1")
    out["b"] = dict(seconds=secs, counts=counts, **v.last_bisect)
    log(f"{tag} (b) 3 tampered of {PER_SET_N}: invalid at {[i for i, ok in enumerate(got) if not ok]} "
        f"= host tier, in {secs:.3f} s; rounds {v.last_bisect['rounds']}, probes "
        f"{v.last_bisect['probes']}; launches {json.dumps(counts)}; "
        f"stages {json.dumps(v.stage_seconds)}")

    arrs = v._marshal(bad)
    got, secs, counts = _run_counted(torch, lambda: v.verify_individual(arrs).cpu().numpy())
    if list(map(bool, got[:PER_SET_N])) != host_bad:
        raise AssertionError("(c) verify_individual's verdicts differ from the host tier's")
    if counts["K3"] != 1:
        raise AssertionError(f"(c) expected one K3 launch, got {counts['K3']}")
    out["c"] = dict(seconds=secs, counts=counts)
    log(f"{tag} (c) verify_individual on the tampered bucket: = host tier in {secs:.6f} s; "
        f"launches {json.dumps(counts)}")

    sixteen = list(sets[:16])
    bad_enc = bytearray(sixteen[7].signature)
    from lodestar_tpu_torch.bls.api import SignatureSet
    from lodestar_tpu_torch.bls.fields import P

    bad_enc[:48] = P.to_bytes(48, "big")  # x.c1 = p under valid flags
    bad_enc[0] |= 0x80 | (sixteen[7].signature[0] & 0x20)
    sixteen[7] = SignatureSet(sixteen[7].pubkey, sixteen[7].message, bytes(bad_enc))
    host16 = _host_verdicts(sixteen)
    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(sixteen))
    if got != host16 or got[7]:
        raise AssertionError("(d) the one-at-a-time verdicts differ from the host tier's")
    # the bad encoding fails to marshal on its own too, so it launches nothing
    if counts["K3"] != 15:
        raise AssertionError(f"(d) expected 15 K3 launches, got {counts['K3']}")
    out["d"] = dict(seconds=secs, counts=counts)
    log(f"{tag} (d) 16 sets, one bad encoding: {sum(got)} True, set 7 False = host tier, "
        f"in {secs:.3f} s; launches {json.dumps(counts)}")
    return out


def phase_pairing_check(torch, np, sets, host_ok, bad, host_bad):
    """Π e(pk_i, H_i)·e(−g1, sig_i) == 1 through `pairing.pairing_check`;
    returns K2's launches of the valid batch's check."""
    from lodestar_tpu_torch.ops import cuda_tower, pairing
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    dev = torch.device("cuda")
    marshal = TorchBlsVerifier(device="cpu")._marshal
    result = {}
    for name, batch, want in (("valid", sets, all(host_ok)), ("tampered", bad, all(host_bad))):
        arrs = marshal(batch)
        t = [torch.as_tensor(getattr(arrs, k)).to(dev)
             for k in ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")]
        xs, ys, qx, qy = cuda_tower.pairing_lanes(*t)
        valid = torch.ones(xs.shape[0], dtype=torch.bool, device=dev)
        got, secs, counts = _run_counted(
            torch, lambda: bool(pairing.pairing_check((xs, ys), (qx, qy), valid)))
        if got != want:
            raise AssertionError(f"pairing_check on the {name} batch: {got}, host tier {want}")
        _need(counts, f"pairing_check ({name})", "K2")
        result[name] = dict(seconds=secs, counts=counts)
        log(f"[pairing-check] {name}: {got} = host tier, {xs.shape[0]} Miller lanes in "
            f"{secs:.3f} s; launches {json.dumps(counts)}")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import lodestar_tpu_torch  # noqa: F401  (fails outside a checkout)
    from lodestar_tpu_torch.ops import cuda_tower

    t_start = time.perf_counter()
    phase_env(torch)
    ptxas = phase_build()
    muls = cuda_tower.fp_muls_per_lane()
    log(f"[build] Fp multiplies per lane (host harness): {json.dumps(muls)}")
    max_err, rows = phase_k1(torch, np)
    k4 = k4_bound(rows[-1]["lanes"])
    log(f"[k4] not ported: its bound at {rows[-1]['lanes']} products, from its shapes: "
        f"{k4[0]:.8f} ms ({k4[1]}; int8 MMA {k4[2]:.8f} ms, bytes {k4[3]:.8f} ms)")
    k2_err, k2_row = phase_k2(torch, np, muls["miller_loop"])
    sets, host_ok, bad, host_bad = per_set_batches(np)
    k3_err, k3_row = phase_k3(torch, np, muls["pairing_fused"], bad, host_bad)
    launches, wall, n_sets = phase_slice(torch, np, 64, 64)
    log(f"[slice] main path (64, 64): {wall:.3f} s per {n_sets}-set verdict, "
        f"{n_sets / wall:.1f} sets/s, {launches} K1 launches per verdict")
    phase_slice(torch, np, 16, 8)
    per_set = phase_per_set(torch, np, sets, host_ok, bad, host_bad)
    checks = phase_pairing_check(torch, np, sets, host_ok, bad, host_bad)
    log(f"[summary] per-set {PER_SET_N}: bisection valid {per_set['a']['seconds']:.3f} s, "
        f"bisection 3 invalid {per_set['b']['seconds']:.3f} s, K3 route "
        f"{per_set['c']['seconds']:.6f} s; script {time.perf_counter() - t_start:.1f} s")
    log(f"[summary] ptxas {json.dumps(ptxas)}")
    stack = k2_row["stack_bytes"] + k3_row["stack_bytes"]
    log(f"[summary] device memory held by the raised stack limit: {stack} B "
        f"({stack / 2**30:.3f} GiB; K2 {k2_row['stack_bytes']} B, then K3 "
        f"{k3_row['stack_bytes']} B more)")

    main_row = rows[-1]
    kernels = {"kernels": [
        {
            "name": "mont_mul",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/mont_mul.cu",
            "replaces": "lodestar_tpu/ops/pallas_fp.py:52",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "miller_loop",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:120",
            "launches": checks["valid"]["counts"]["K2"],
            "max_abs_err": k2_err,
            "ms": k2_row["ms"],
            "plain_ms": k2_row["plain_ms"],
            "bound_ms": k2_row["bound_ms"],
            "bound_by": k2_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "pairing_fused",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:240",
            "launches": per_set["d"]["counts"]["K3"],
            "max_abs_err": k3_err,
            "ms": k3_row["ms"],
            "plain_ms": k3_row["plain_ms"],
            "bound_ms": k3_row["bound_ms"],
            "bound_by": k3_row["bound_by"],
            "library_ms": None,
        },
    ]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
