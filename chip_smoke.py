"""Smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. env    the card's name and power limit, the torch and CUDA versions.
2. build  K1 (`csrc/mont_mul.cu`, nvcc, sm_90a) and the C host tier
          (`csrc/host/`, cc) from the checkout, in parallel, into
          build/lodestar_tpu_torch/.
3. k1     K1 against its plain PyTorch version on the card, limb for limb
          (tolerance 0), on random values in [0, 2p) plus the edges 0, 1,
          p−1, p and 2p−1, at the lane counts the main path uses; then
          CUDA-event timings of both beside the byte bound.
4. slice  4096 signature sets over 64 signing roots (one slot of mainnet
          attestation gossip) made from a fixed seed with the host tier,
          verified by `TorchBlsVerifier` at the (64, 64) configuration:
          True on the valid batch, False on four tampered ones, each equal
          to the host tier's CPU verdict; the same for 128 sets over 16
          roots, the (16, 8) configuration. K1's launch count is reset just
          before the timed main-path verdict and read just after.
5. the `kernels` line, the card line, and the last line
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
    from lodestar_tpu_torch import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(build.mont_mul_cuda), pool.submit(build.host_tier)]
        for job in jobs:
            job.result()
    log(f"[build] K1 and host tier built in {time.perf_counter() - t0:.1f} s")
    for name, (secs, text) in sorted(build.BUILD_LOG.items()):
        log(f"[build] {name}: {secs:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import lodestar_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_env(torch)
    phase_build()
    max_err, rows = phase_k1(torch, np)
    launches, wall, n_sets = phase_slice(torch, np, 64, 64)
    log(f"[slice] main path (64, 64): {wall:.3f} s per {n_sets}-set verdict, "
        f"{n_sets / wall:.1f} sets/s, {launches} K1 launches per verdict")
    phase_slice(torch, np, 16, 8)

    main_row = rows[-1]
    kernels = {"kernels": [{
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
    }]}
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
