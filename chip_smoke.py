"""Smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. env    the card's name and power limit, the torch and CUDA versions, the
          per-thread stack limit (`cudaLimitStackSize`, read through the
          CUDA runtime with ctypes); no phase may raise it.
2. build  K1 (`csrc/mont_mul.cu`), K2/K2p/K3/K3-fe (`csrc/tower.cu`) and K4
          (`csrc/mxu_mont.cu`), each with nvcc for sm_90a, the C host tier
          (`csrc/host/`, cc) and the K2/K3 host harness (`csrc/tower_host.cpp`,
          c++) from the checkout, all at once, into build/lodestar_tpu_torch/;
          ptxas's registers, stack and spills of every kernel.
3. k1     K1, a half-warp per product, against its plain PyTorch version
          on the card, limb for limb (tolerance 0): the 36 pairs of the
          edges 0, 1, p−1, p, 2p−1 and 2^381 − 1 (all ones below 2p), then
          random values in [0, 2p) at 1, 13 (a tail that is not a multiple
          of its 8 products per block), 128 and 2,048 (the grouped
          verdict's smallest and largest counts), 4096 and 589,824
          products; at each its device time (launches captured in a CUDA
          graph, replayed between two events: the host's wrapper left
          out), its call time (Python calls back to back between two
          events), the plain version's time, the byte bound and the share;
          ptxas's registers, shared memory, stack and spills of
          `mont_mul_kernel`.
4. k4     K4, the integer-tensor-core multiply, against its plain version
          and against K1, limb for limb, on the 36 edge pairs (padded to
          4096 products) and at 4096, 4097 (a partial warp tile), 8,192,
          65,536, 262,144 and 589,824 products; the device and call times
          of K4 and K1 side by side and the plain version's time beside
          K4's bound.
4a. fe    K3-fe, the final exponentiation with one warp per lane (before
          any other tower kernel, so that its first-launch memory is its
          own), against `final_exp_plain` (the batch form, one shared
          inversion) at 1, 16 (the bisection's probe) and 256 lanes of
          random Fp12 values in [0, 2p), with a zero lane and an identity
          lane from 16 lanes up: equal canonical values, zero to zero, the
          identity to one; ptxas's registers, shared memory, stack and
          spills of `final_exp_warp_kernel`, the device memory its first
          launch takes (no stack limit is raised for it), its device time
          (CUDA-graph replay) and call time, the plain version's time, the
          bound (the fewest Fp multiplies the function needs per lane,
          from the host build; the schedule's own count is reported
          beside it) and the time per dependent round (the host build's
          count of rounds).
4b. k2p   K2p, the projective Miller loop of the batch verdicts with one
          warp per lane (before K3 and K2, so that its first-launch memory
          is its own), against `miller_loop_proj_plain` at 8 and 192 lanes
          (the grouped verdict's 2R + 64): G1 pubkeys and H(m) points from
          the host tier times random Z (Zp ∈ Fp, Zq ∈ Fp2), every
          coordinate in [p, 2p); lane 0 with Zp = 0 and lane 1 with Zq = 0
          must only not fault and are left out of the comparison. Equal
          canonical values (tolerance 0); ptxas's figures of
          `miller_proj_warp_kernel` (it fails on a stack frame or a
          spill), first-launch memory, device and call times, the bound
          (the fewer Fp multiplies per lane of the one-thread lane and the
          warp schedule) and the time per round, as for K3-fe.
4c. k3    K3, the fused per-set pairing (two warps per set run K2p's Miller
          program at unit Z, then one of them the product and K3-fe's final
          exponentiation): against `pairing_fused_plain` on 4 and
          128 marshalled sets with three invalid sets and one zero lane,
          equal canonical values and verdicts equal to the host tier's;
          ptxas's figures of `pairing_warp_kernel` (it fails on a stack
          frame or a spill), first-launch memory, device time (graph
          replay) and call time, the plain version's time, the bound (the
          fewest Fp multiplies a set needs) and the time per round (the
          host build's count: one Miller warp's, the product's and the
          final exponentiation's rounds).
5. k2     K2, the affine Miller loop (one warp per lane running K2p's
          Miller program at unit Z), against `miller_loop_plain` on G1
          pubkeys and H(m) points made with the host tier, the odd lanes'
          coordinates in [p, 2p), plus one all-zero lane (f = 0), at 8 and
          256 lanes (the 2 × 128 Miller lanes of a 128-set per-set batch):
          equal canonical values (tolerance 0); ptxas's figures of
          `miller_warp_kernel` (it fails on a stack frame or a spill),
          first-launch memory, device time (graph replay) and call time,
          the plain version's time, the bound (the fewer Fp multiplies per
          lane of the one-thread lane and the schedule) and the time per
          round; it fails if the stack limit is above its start value.
6. slice  4096 signature sets over 64 signing roots (one slot of mainnet
          attestation gossip) made from a fixed seed with the host tier,
          verified by `TorchBlsVerifier` at the (64, 64) configuration:
          True on the valid batch, False on four tampered ones, each equal
          to the host tier's CPU verdict; the same for 128 sets over 16
          roots, the (16, 8) configuration.
7. pk-grouped  4096 sets over 4096 unique roots signed by 128 keys (the
          default (128, 32) configuration): the valid batch (first call, and
          warm with the hash-to-G2 cache emptied, as a flood of unique roots
          always finds it) and three tampered ones (a wrong message, two
          signatures swapped, bad flag bits), each equal to the host tier's
          verdict.
8. flat   128 sets over 128 roots and 128 keys (valid, one wrong message)
          and 200 such sets (two chunks).
9. split  64 sets over 8 shared roots plus 64 sets over 64 unique roots,
          from 2 keys (the rest goes pk-grouped) or from 64 keys (flat); each
          valid and with one tampered set in the unique part.
10. per-set  128 sets over 128 signing roots (a block's attestations),
          `verify_signature_sets_individual` on the card: (a) the valid
          batch, all True by the root alone; (b) three tampered sets,
          found by bisection; (c) `verify_individual` on the tampered
          bucket, one K3 launch; (d) 16 sets with one bad encoding, one
          set at a time (`_verify_one`). Every list equals the host tier's
          per-set verdicts.
11. pairing-check  `pairing.pairing_check`, the multi-pairing primitive, over
          the 2 × 128 affine pairs of the valid and of the tampered batch:
          the path that runs K2 (one launch per check) and K3-fe.
12. serve  the port's `DeviceBlsVerifier` facade with a recording observer:
          `epoch_table_populate` with the phase's 128 keys (rows, device
          bytes, seconds), `warm_h2c` over its 16 roots, one full 128-set
          job (grouped 16 × 8) valid and with three bad signatures, then
          `verify_signature_sets_individual` on the tampered job. Every
          verdict equals the host tier's; no pubkey is decompressed (a spy
          on `native.g1_decompress`: the table serves them all); the
          observer sees two root-grouped and one individual planner path,
          every stage, a bisection with rounds, hash-cache hits and 128
          epoch-table hits; K2p and K3-fe launch once per batch verdict.

The main-path verdicts of phases 6-12 run with the launch counts of K1-K4,
K2p and K3-fe reset just before and read just after, and fail if a kernel
of their path was launched no time: K2p and K3-fe once per batch verdict
(per part of a split one, per chunk of a flat one), both on bisection;
every verdict of phases 7-9 is counted so and also checks which planner
paths ran.

13. the `kernels` line, the card line, and the last line
          {"ok": true, "device": {"platform": "gpu", ...}}. K1's and K4's
          entries give their device times (`ms`) and call times
          (`call_ms`) per launch over the product counts that their
          main-path verdict gave them (the grouped (64, 64) verdict for K1,
          the pk-grouped one for K4), each count checked limb for limb and
          timed anew. K2's entry is timed at 256 lanes, K2p's at 192,
          K3-fe's at 1 and K3's at 128 sets, their main-path shapes; the
          four also give their call time, rounds, µs per round and their
          schedule's Fp multiplies per lane.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

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
    builds = (build.mont_mul_cuda, build.tower_cuda, build.mxu_cuda, build.host_tier,
              build.tower_host)
    with ThreadPoolExecutor(len(builds)) as pool:
        for job in [pool.submit(b) for b in builds]:
            job.result()
    log(f"[build] K1, K2/K2p/K3/K3-fe, K4, host tier and tower host harness built in "
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
    """Call time: milliseconds per Python call of `fn`, back to back between
    two events (the wrapper's checks, allocation and launch included)."""
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


def _device_ms(torch, fn, iters: int) -> float:
    """Device time: milliseconds per call of `fn` with the host's wrapper
    left out, from `iters` calls captured in one CUDA graph and replayed
    between two events (the kernels and the gaps between them)."""
    fn()  # warm: the build, the cached constants, the launch shape
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _iters(n: int) -> int:
    return 200 if n <= 8192 else 50 if n <= 65536 else 20


# products: one; a tail that is not a multiple of K1's 8 per block; the
# grouped verdict's smallest and largest counts (128, 2,048); the lane
# rule's switch to K4 (4,096); the pk-grouped path's largest count
K1_SIZES = (1, 13, 128, 2048, 4096, 589824)


def phase_k1(torch, np, ptxas: dict):
    """K1 against its plain version, limb for limb, on the edge pairs and at
    K1_SIZES, with its device and call times, the plain version's time and
    the bound; returns (max_err, {products: row}, ptxas figures)."""
    from lodestar_tpu_torch.ops import cuda_fp

    figs = _kernel_ptxas(ptxas, "mont_mul_kernel")
    log(f"[k1] mont_mul_kernel (a half-warp per product): {figs.get('registers')} registers, "
        f"{figs.get('smem', 0)} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    a_np, b_np = _edge_pairs(np, rng, 64)
    cases = [("edges", a_np, b_np)]
    for n in K1_SIZES:
        cases.append((str(n), _random_limbs(rng, n), _random_limbs(rng, n)[::-1].copy()))
    max_err = 0
    rows = {}
    for name, a_np, b_np in cases:
        a, b = torch.as_tensor(a_np).to(dev), torch.as_tensor(b_np).to(dev)
        n = a.shape[0]
        got = cuda_fp.mont_mul_cuda(a, b)
        want = cuda_fp.mont_mul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K1 differs from its plain version at {name} products")
        if name == "edges":
            log(f"[k1] the {len(_edge_values()) ** 2} edge pairs (padded to {n}): match=exact")
            continue
        iters = _iters(n)
        ms = _device_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        call_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        plain_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_plain(a, b), max(3, iters // 10))
        bound_ms, bound_by = k1_bound(n)
        rows[n] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[k1] products={n} match=exact device_ms={ms:.6f} call_ms={call_ms:.6f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.6f}")
    return max_err, rows, figs


def k1_bound(lanes: int):
    """K1's (bound_ms, bound_by) at `lanes` products: 384 B moved and the
    2·12² int32 products of its 12 × 12 digit schoolbook, each a mul.lo and
    a mul.hi, per product."""
    bytes_ms = 384 * lanes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 12 * 12 * 2 * lanes / INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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
    """Drive TorchBlsVerifier on one batch shape; returns the launch counts
    of the main-path verdict and its wall time."""
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
    torch.cuda.reset_peak_memory_stats()
    with _products_per_launch() as products:
        verdict, wall, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v)
    _check_products(products, counts, tag)
    stages = dict(v.stage_seconds)
    if verdict is not True:
        raise AssertionError("the port rejects the valid batch (warm)")
    _need(counts, f"{tag} main path", "K1")
    _need_main(counts, f"{tag} main path")
    host_s = stages.get("marshal", 0.0) + stages.get("rand", 0.0)
    log(f"{tag} warm verdict True in {wall:.3f} s = {len(sets) / wall:.1f} sets/s; "
        f"launches {json.dumps(counts)}; host marshal+rand share {host_s / wall:.6f} "
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
    return counts, wall, len(sets), products


# K4 computes K1's function, REDC(a·b), with its constant products on the
# integer tensor cores. The ceiling of what the function needs there: three
# 32 × 32 limb-product contractions (a·b, t·N′, m·p), each limb product four
# u8 × u8 multiply-adds of its lo/hi bytes. K4 issues 6,656 per product (its
# a·b runs on the CUDA cores, t·N′ and m·p on bytes; `csrc/mxu_mont.cuh`), its
# TPU formulation 208,896 (a dense contraction with the 0/1 matrix S). Every
# shape is bytes-bound either way.
K4_MACS_PER_PRODUCT = 3 * 4 * 32 * 32
INT8_MMA_OPS_PER_S = 1979e12  # dense int8 tensor-core peak


def k4_bound(lanes: int):
    """K4's (bound_ms, bound_by) at `lanes` products: the larger of its
    384 B moved and the multiply-adds REDC(a·b) needs."""
    ops_ms = 2 * K4_MACS_PER_PRODUCT * lanes / INT8_MMA_OPS_PER_S * 1e3
    bytes_ms = 384 * lanes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# products: the main path's 4096; 4097, a partial warp tile; the pk-grouped
# path's 8,192 and 589,824; and sizes between
K4_SIZES = (4096, 4097, 8192, 65536, 262144, 589824)


def _edge_values():
    """0, 1, p−1, p, 2p−1 and 2^381 − 1, the all-ones value below 2p (its
    words give the largest word products)."""
    from lodestar_tpu_torch.bls.fields import P

    return (0, 1, P - 1, P, 2 * P - 1, 2**381 - 1)


def _edge_pairs(np, rng, n: int):
    """The 36 pairs of `_edge_values()`, padded with random values in [0, 2p) to
    n products."""
    from lodestar_tpu_torch.ops.limbs import int_to_limbs

    edges = [int_to_limbs(v) for v in _edge_values()]
    k = len(edges) ** 2
    a = _random_limbs(rng, n)
    b = _random_limbs(rng, n)
    a[:k] = [x for x in edges for _ in edges]
    b[:k] = [y for _ in edges for y in edges]
    return a, b


def phase_k4(torch, np):
    """K4 against its plain version and against K1, limb for limb, then the
    device and call times of K4 and K1 and the plain version's time beside
    K4's bound; returns (max_err, {products: row})."""
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device("cuda")
    cases = [("edges", *_edge_pairs(np, rng, 4096))]
    for n in K4_SIZES:
        cases.append((str(n), _random_limbs(rng, n), _random_limbs(rng, n)[::-1].copy()))
    max_err = 0
    rows = {}
    for name, a_np, b_np in cases:
        a, b = torch.as_tensor(a_np).to(dev), torch.as_tensor(b_np).to(dev)
        n = a.shape[0]
        got = cuda_mxu.mont_mul_mxu_cuda(a, b)
        plain = cuda_mxu.mont_mul_mxu_plain(a, b)
        k1 = cuda_fp.mont_mul_cuda(a, b)
        torch.cuda.synchronize()
        err = max(int((got.long() - plain.long()).abs().max()),
                  int((got.long() - k1.long()).abs().max()))
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K4 differs from its plain version or K1 at {name} products")
        if name == "edges":
            log(f"[k4] the {len(_edge_values()) ** 2} edge pairs (padded to {n}): match=exact "
                f"against plain and K1")
            continue
        iters = _iters(n)
        ms = _device_ms(torch, lambda: cuda_mxu.mont_mul_mxu_cuda(a, b), iters)
        k1_ms = _device_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        call_ms = _time_ms(torch, lambda: cuda_mxu.mont_mul_mxu_cuda(a, b), iters)
        k1_call_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        plain_ms = _time_ms(torch, lambda: cuda_mxu.mont_mul_mxu_plain(a, b), 3)
        bound_ms, bound_by = k4_bound(n)
        rows[n] = dict(ms=ms, call_ms=call_ms, k1_ms=k1_ms, k1_call_ms=k1_call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[k4] products={n} match=exact device_ms={ms:.6f} call_ms={call_ms:.6f} "
            f"k1_device_ms={k1_ms:.6f} k1_call_ms={k1_call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"k1_share_of_bound={bound_ms / k1_ms:.6f}")
    return max_err, rows


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
    Around a tower kernel's first launch this is the memory the launch
    itself takes: a raised per-thread stack limit would reserve local
    memory for every resident thread; the lazily loaded code of the
    module's kernel takes one 2 MiB granule or nothing."""
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


def stack_limit() -> int:
    """The current device's per-thread stack limit (`cudaLimitStackSize`),
    read through the CUDA runtime that this process loaded."""
    import ctypes

    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f if "libcudart" in line})
    lib = ctypes.CDLL(paths[0] if paths else "libcudart.so")
    value = ctypes.c_size_t(0)
    rc = lib.cudaDeviceGetLimit(ctypes.byref(value), 0)  # 0: cudaLimitStackSize
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetLimit failed: CUDA error {rc}")
    return int(value.value)


def _high_half(np, cols):
    """The odd lanes' coordinates as their value plus p, in [p, 2p)."""
    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import int_to_limbs, limbs_to_int

    for a in cols:
        flat = a.reshape(a.shape[0], -1, 32)
        for i in range(1, a.shape[0], 2):
            for j in range(flat.shape[1]):
                flat[i, j] = int_to_limbs(limbs_to_int(flat[i, j]) + P)
    return cols


def phase_k2(torch, np, muls: dict, ptxas: dict, stack_at_start: int):
    """K2 against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower

    figs = _kernel_ptxas(ptxas, "miller_warp_kernel")
    rounds = muls["miller_loop_warp_rounds"]
    log(f"[k2] miller_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['miller_loop_warp']} Fp multiplies and {rounds} dependent rounds per lane in "
        f"its schedule, {muls['miller_loop']} in the one-thread lane; the bound counts the "
        f"fewer, {muls['miller_loop_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K2's kernel uses a stack or spills: its launcher raises no limit")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in K2_LANES:
        cols = _high_half(np, list(_miller_inputs(np, n, SEED + n)))
        args = [torch.as_tensor(a).to(dev) for a in cols]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.miller_loop_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k2] first launch took {taken} B of device memory ({taken / 2**20:.1f} MiB)")
        want = cuda_tower.miller_loop_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K2 differs from its plain version at {n} lanes")
        if not bool((got[0] == 0).all()):
            raise AssertionError("K2's all-zero lane did not give 0")
        ms = _device_ms(torch, lambda: cuda_tower.miller_loop_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.miller_loop_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.miller_loop_plain(*args))
        bound_ms, bound_by = _bound(muls["miller_loop_fewest"], K2_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["miller_loop_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[k2] lanes={n} match=canonical (zero lane 0, odd lanes in [p, 2p)) "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    limit = stack_limit()
    log(f"[k2] stack limit {limit} B after the phase, {stack_at_start} B at the start")
    if limit > stack_at_start:
        raise AssertionError("the per-thread stack limit was raised")
    return max_err, rows


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


def phase_k3(torch, np, muls: dict, ptxas: dict, bad, host_bad):
    """K3 against its plain version and the host tier's verdicts; returns
    (max_err, {sets: row})."""
    from lodestar_tpu_torch.ops import cuda_tower, fp12
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    figs = _kernel_ptxas(ptxas, "pairing_warp_kernel")
    rounds = muls["pairing_warp_rounds"]
    log(f"[k3] pairing_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['pairing_warp']} Fp multiplies and {rounds} dependent rounds per set in its "
        f"schedule, {muls['pairing_fused']} in the one-thread set; the bound counts the "
        f"fewest a set needs, {muls['pairing_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K3's kernel uses a stack or spills: its launcher raises no limit")
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
    rows = {}
    first_bytes = None
    for lanes in (slice(3, 7), slice(0, PER_SET_N)):
        args = [torch.as_tensor(cols[k][lanes]).to(dev) for k in names]
        n = args[0].shape[0]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.pairing_fused_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k3] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB)")
        want = cuda_tower.pairing_fused_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K3 differs from its plain version at {n} sets")
        ok = fp12.is_one(got).cpu().numpy()
        if not (ok == want_ok[lanes]).all():
            raise AssertionError(f"K3's verdicts differ from the host tier's at {n} sets")
        ms = _device_ms(torch, lambda: cuda_tower.pairing_fused_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.pairing_fused_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.pairing_fused_plain(*args))
        bound_ms, bound_by = _bound(muls["pairing_fewest"], K3_BYTES_PER_SET, n)
        rows[n] = dict(sets=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["pairing_warp"], first_launch_bytes=first_bytes,
                       ptxas=figs)
        log(f"[k3] sets={n} match=canonical verdicts=host_tier invalid={int((~ok).sum())} "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


K2P_LANES = (8, 2 * 64 + 64)  # the grouped (64, 64) verdict's 2R + 64 Miller lanes
K2P_BYTES_PER_LANE = 4 * (3 * 32 + 3 * 64 + 384)  # P and Q projective in; the Fp12 out
FE_LANES = (1, 16, 256)  # a batch verdict's one product; the bisection probe; 256
FE_BYTES_PER_LANE = 4 * (384 + 384)  # the Fp12 in and out


def _projective_inputs(np, n: int, seed: int):
    """n projective Miller lanes: `_miller_inputs`'s affine points times
    random Z (Zp ∈ Fp, Zq ∈ Fp2, Montgomery form), every coordinate as
    its value plus p, in [p, 2p); lane 0 gets Zp = 0, lane 1 Zq = 0."""
    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs, limbs_to_int

    xp, yp, xq, yq = _miller_inputs(np, n, seed)
    rng = np.random.default_rng(seed + 1)
    r = R_MONT % P

    def rand_fp() -> int:
        return int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1

    def high(v: int):
        return int_to_limbs(v % P + P)

    p_out = [np.empty_like(xp) for _ in range(3)]
    q_out = [np.empty_like(xq) for _ in range(3)]
    for i in range(n):
        z = rand_fp()
        for c, a in ((0, xp), (1, yp)):
            p_out[c][i] = high(limbs_to_int(a[i]) * z)
        p_out[2][i] = high(z * r)
        z0, z1 = rand_fp(), rand_fp()
        for c, a in ((0, xq), (1, yq)):
            a0, a1 = limbs_to_int(a[i, 0]), limbs_to_int(a[i, 1])
            q_out[c][i] = [high(a0 * z0 - a1 * z1), high(a0 * z1 + a1 * z0)]
        q_out[2][i] = [high(z0 * r), high(z1 * r)]
    p_out[2][0] = 0
    q_out[2][1] = 0
    return p_out + q_out


def _kernel_ptxas(ptxas: dict, kernel: str) -> dict:
    """ptxas's figures for one kernel (registers, shared memory, stack
    frame, spill stores and loads)."""
    for name, figs in ptxas.items():
        if kernel in name:
            return figs
    raise AssertionError(f"ptxas reported no figures for {kernel}")


def phase_k2p(torch, np, muls: dict, ptxas: dict):
    """K2p against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower

    figs = _kernel_ptxas(ptxas, "miller_proj_warp_kernel")
    rounds = muls["miller_loop_proj_warp_rounds"]
    log(f"[k2p] miller_proj_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['miller_loop_proj_warp']} Fp multiplies and {rounds} dependent rounds per lane "
        f"in its schedule, {muls['miller_loop_proj']} in the one-thread lane; the bound counts "
        f"the fewer, {muls['miller_loop_proj_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K2p's kernel uses a stack or spills: its launcher raises no limit")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in K2P_LANES:
        args = [torch.as_tensor(a).to(dev) for a in _projective_inputs(np, n, SEED + 30 + n)]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k2p] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB)")
        want = cuda_tower.miller_loop_proj_plain(*args)
        torch.cuda.synchronize()
        if not bool((got[:2] >= 0).all() & (got[:2] < 4096).all()):
            raise AssertionError("K2p's Zp = 0 / Zq = 0 lanes returned no limbs")
        err = _canonical_err(torch, got[2:], want[2:])
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K2p differs from its plain version at {n} lanes")
        ms = _device_ms(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.miller_loop_proj_plain(*args))
        bound_ms, bound_by = _bound(muls["miller_loop_proj_fewest"], K2P_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["miller_loop_proj_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[k2p] lanes={n} match=canonical (lanes 2..{n - 1}; Zp = 0, Zq = 0 lanes ran) "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


def _fp12_inputs(np, n: int, seed: int):
    """n Fp12 lanes of random values in [0, 2p) (the edges 0, 1, p−1, p and
    2p−1 among lane 0's coefficients); from 16 lanes up, lane 1 is zero and
    lane 2 the identity."""
    from lodestar_tpu_torch.ops.limbs import ONE_MONT_LIMBS

    fs = _random_limbs(np.random.default_rng(seed), 12 * n).reshape(n, 2, 3, 2, 32)
    if n >= 16:
        fs[1] = 0
        fs[2] = 0
        fs[2, 0, 0, 0] = ONE_MONT_LIMBS
    return fs


def phase_fe(torch, np, muls: dict, ptxas: dict):
    """K3-fe against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower, fp12

    figs = _kernel_ptxas(ptxas, "final_exp_warp_kernel")
    rounds = muls["final_exp_warp_rounds"]
    log(f"[fe] final_exp_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['final_exp_warp']} Fp multiplies and {rounds} dependent rounds per lane in "
        f"its schedule, {muls['final_exp_fewest']} the fewest the function needs (the "
        f"bound's count; host counts)")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in FE_LANES:
        fs = torch.as_tensor(_fp12_inputs(np, n, SEED + 40 + n)).to(dev)
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.final_exp_cuda(fs))
        if first_bytes is None:
            first_bytes = taken
            log(f"[fe] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB), before any other tower kernel ran")
        want = cuda_tower.final_exp_plain(fs)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K3-fe differs from its plain version at {n} lanes")
        if n >= 16 and not (bool((got[1] == 0).all()) and bool(fp12.is_one(got[2]))):
            raise AssertionError("K3-fe: the zero lane or the identity lane went astray")
        ms = _device_ms(torch, lambda: cuda_tower.final_exp_cuda(fs), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.final_exp_cuda(fs), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.final_exp_plain(fs))
        bound_ms, bound_by = _bound(muls["final_exp_fewest"], FE_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["final_exp_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[fe] lanes={n} match=canonical{' (zero and identity lanes held)' if n >= 16 else ''} "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


def _counts():
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu, cuda_tower

    return {"K1": cuda_fp.LAUNCHES, "K2": cuda_tower.MILLER_LAUNCHES,
            "K3": cuda_tower.PAIRING_LAUNCHES, "K4": cuda_mxu.LAUNCHES,
            "K2p": cuda_tower.MILLER_PROJ_LAUNCHES, "K3-fe": cuda_tower.FINAL_EXP_LAUNCHES}


def _reset_counts():
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu, cuda_tower

    cuda_fp.LAUNCHES = 0
    cuda_tower.MILLER_LAUNCHES = 0
    cuda_tower.MILLER_PROJ_LAUNCHES = 0
    cuda_tower.PAIRING_LAUNCHES = 0
    cuda_tower.FINAL_EXP_LAUNCHES = 0
    cuda_mxu.LAUNCHES = 0


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


@contextmanager
def _products_per_launch():
    """{"K1": Counter, "K4": Counter}: the products of every K1 and K4
    launch made inside the block, seen by wrapping the two wrappers (which
    still count the launches)."""
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    seen = {"K1": Counter(), "K4": Counter()}
    wrapped = [(cuda_fp, "mont_mul_cuda", "K1"), (cuda_mxu, "mont_mul_mxu_cuda", "K4")]
    saved = [getattr(mod, name) for mod, name, _ in wrapped]
    for (mod, name, key), fn in zip(wrapped, saved):
        def spy(a, b, _fn=fn, _seen=seen[key]):
            out = _fn(a, b)
            if a.numel():  # an empty call launches nothing
                _seen[a.numel() // 32] += 1
            return out

        setattr(mod, name, spy)
    try:
        yield seen
    finally:
        for (mod, name, _), fn in zip(wrapped, saved):
            setattr(mod, name, fn)


def _check_products(products: dict, counts: dict, tag: str):
    for k, seen in products.items():
        if sum(seen.values()) != counts[k]:
            raise AssertionError(f"{tag}: {counts[k]} {k} launches, {sum(seen.values())} seen")
    log(f"{tag} products per launch -> launches: "
        + "; ".join(f"{k} {json.dumps(dict(sorted(v.items())))}" for k, v in products.items()))


def launch_mix(torch, np, name: str, mix: Counter, kernel, plain, bound):
    """The device and call times per launch of `kernel`, the plain version's
    time and the bound, each the mean over the main path's launches (`mix`:
    products → launches); every product count checked limb for limb
    against the plain version and timed anew on random operands."""
    rng = np.random.default_rng(SEED + 21)
    dev = torch.device("cuda")
    total = sum(mix.values())
    ms = call_ms = plain_ms = bound_ms = 0.0
    bound_parts = Counter()  # the mean bound, split by what bounds each count
    for n, k in sorted(mix.items()):
        a = torch.as_tensor(_random_limbs(rng, n)).to(dev)
        b = torch.as_tensor(_random_limbs(rng, n)[::-1].copy()).to(dev)
        if not torch.equal(kernel(a, b), plain(a, b)):
            raise AssertionError(f"[{name}] the kernel differs from its plain version at "
                                 f"{n} products")
        t = _device_ms(torch, lambda: kernel(a, b), 50)
        tc = _time_ms(torch, lambda: kernel(a, b), 50)
        tp = _time_ms(torch, lambda: plain(a, b), 3)
        bd, by = bound(n)
        log(f"[{name}] products={n} launches={k} match=exact device_ms={t:.6f} call_ms={tc:.6f} "
            f"plain_ms={tp:.6f} bound_ms={bd:.8f} ({by})")
        ms += k * t / total
        call_ms += k * tc / total
        plain_ms += k * tp / total
        bound_ms += k * bd / total
        bound_parts[by] += k * bd / total
    by = max(bound_parts, key=bound_parts.get)
    log(f"[{name}] per launch over {total} main-path launches: device_ms={ms:.6f} "
        f"call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} ({by}) "
        f"share_of_bound={bound_ms / ms:.6f}")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def _need(counts: dict, route: str, *kernels):
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{route}: the route launched {k} no time")


def _need_main(counts: dict, route: str, verdicts: int = 1):
    """A batch verdict's Miller stage and final exponentiation: K2p and
    K3-fe launched once per verdict (per part or chunk)."""
    for k in ("K2p", "K3-fe"):
        if counts[k] != verdicts:
            raise AssertionError(f"{route}: {counts[k]} {k} launches, expected {verdicts}")


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
    _need(counts, "(a) bisection, valid", "K1", "K2p", "K3-fe")
    if counts["K3"] != 0:
        raise AssertionError("(a) the root passed, yet K3 was launched")
    out["a"] = dict(seconds=secs, counts=counts, **v.last_bisect)
    log(f"{tag} (a) {PER_SET_N} valid sets: all True in {secs:.3f} s (first call); "
        f"launches {json.dumps(counts)}; rounds {v.last_bisect['rounds']}; "
        f"stages {json.dumps(v.stage_seconds)}")

    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(bad), v)
    if got != host_bad:
        raise AssertionError("(b) the tampered batch's per-set verdicts differ from the host tier's")
    _need(counts, "(b) bisection, three invalid", "K1", "K2p", "K3-fe")
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
    """Π e(pk_i, H_i)·e(−g1, sig_i) == 1 through `pairing.pairing_check`
    (K2, then K3-fe on the product); returns the launches of each check."""
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
        _need(counts, f"pairing_check ({name})", "K2", "K3-fe")
        if counts["K2p"] != 0:
            raise AssertionError(f"pairing_check ({name}): K2p launched on an affine route")
        result[name] = dict(seconds=secs, counts=counts)
        log(f"[pairing-check] {name}: {got} = host tier, {xs.shape[0]} Miller lanes in "
            f"{secs:.3f} s; launches {json.dumps(counts)}")
    return result


SERVE_ROOTS, SERVE_PER_ROOT = 16, 8  # one full 128-set job: the grouped (16, 8) shape


class ServeObserver:
    """A recording observer for the facade: counts of planner paths,
    stages, cache and epoch-table events, and the bisection outcomes.
    Thread-safe: the marshal pool's threads call it."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.counts = Counter()
        self.bisects = []

    def _add(self, key, n: int = 1):
        with self._lock:
            self.counts[key] += n

    def stage(self, name):
        from contextlib import nullcontext

        self._add(("stage", name))
        return nullcontext()

    def observe_stage(self, name, seconds):
        self._add(("stage", name))

    def planner(self, path, n_sets, group_sizes=None):
        self._add(("planner", path))

    def cache_event(self, cache, hit, n=1):
        self._add((cache, "hit" if hit else "miss"), n)

    def epoch_table_event(self, hit, n=1):
        self._add(("epoch_table", "hit" if hit else "miss"), n)

    def epoch_table_occupancy(self, rows):
        self._add(("epoch_table", "occupancy_updates"))

    def epoch_table_eviction(self, n=1):
        self._add(("epoch_table", "eviction"), n)

    def bisect(self, rounds, probes):
        with self._lock:
            self.bisects.append((rounds, probes))

    def device_busy_sample(self, busy_s):
        self._add(("device_busy_sample",))

    def decompress_fallback(self, n=1):
        self._add(("decompress_fallback",), n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"/".join(k): v for k, v in sorted(self.counts.items())}


def phase_serve(torch, np):
    """The port's `DeviceBlsVerifier` on the card, as a serving stack calls
    it: the epoch table populated with the phase's 128 keys, the hash
    cache warmed over its 16 roots, then one full 128-set job (grouped
    16 × 8) valid and with three bad signatures, and the per-set verdicts
    of the tampered job. Every verdict equals the host tier's, every
    pubkey comes from the table (no G1 decompression), and the observer
    sees the planner paths and the stage, bisect and cache events."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
    from lodestar_tpu_torch.profile_verdict import make_sets

    tag = "[serve]"
    sets = make_sets(SERVE_ROOTS, SERVE_PER_ROOT, seed=SEED + 50, threads=THREADS)
    bad = sets
    for k in (5, 64, 127):  # another key's signature over the same root
        bad = _tamper_one(bad, k, "signature", k - 1)
    host_ok, host_bad = _host_verdicts(sets), _host_verdicts(bad)
    if not all(host_ok) or [i for i, ok in enumerate(host_bad) if not ok] != [5, 64, 127]:
        raise AssertionError(f"{tag} the host tier's verdicts are not the expected ones")
    obs = ServeObserver()
    dev = DeviceBlsVerifier(device="cuda", observer=obs, rng=np.random.default_rng(SEED))
    out = {}

    t0 = time.perf_counter()
    rows = dev.epoch_table_populate(0, [s.pubkey.to_bytes() for s in sets])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snap = dev.epoch_table_snapshot()
    table = dev._inner._epoch_table
    out["populate"] = dict(rows=rows, device_bytes=table.device_bytes(), seconds=secs)
    log(f"{tag} epoch_table_populate: {rows} rows, {table.device_bytes()} B on the device, "
        f"{secs:.6f} s; snapshot {json.dumps(snap)}")
    if rows != len(sets) or not snap["entries"][0]["device_resident"]:
        raise AssertionError(f"{tag} the epoch table does not hold every key on the device")
    gathered = table.gather_device(0, [0, rows - 1])
    want = []
    for s in (sets[0], sets[-1]):
        rc, limbs = native.g1_decompress(s.pubkey.to_bytes(), check_subgroup=False)
        want.append(np.concatenate(limbs))
    if rc != 0 or not np.array_equal(gathered.cpu().numpy(), np.stack(want)):
        raise AssertionError(f"{tag} the device rows differ from the decompressed keys")

    t0 = time.perf_counter()
    hashed = dev.warm_h2c({s.message for s in sets})
    secs = time.perf_counter() - t0
    out["warm_h2c"] = dict(hashed=hashed, seconds=secs)
    log(f"{tag} warm_h2c: {hashed} roots hashed in {secs:.6f} s; cache {dev.h2c_cache_size()}")
    if hashed != SERVE_ROOTS:
        raise AssertionError(f"{tag} warm_h2c hashed {hashed} roots, expected {SERVE_ROOTS}")

    decompressions = Counter()
    real = native.g1_decompress

    def spy(*args, **kwargs):
        decompressions["g1"] += 1
        return real(*args, **kwargs)

    native.g1_decompress = spy
    try:
        for name, batch, want in (("valid", sets, True), ("three bad signatures", bad, False)):
            got, secs, counts = _run_counted(
                torch, lambda: dev.verify_signature_sets(batch), dev._inner)
            log(f"{tag} {len(batch)}-set job, {name}: port {got}, host tier {want}, "
                f"{secs:.3f} s; launches {json.dumps(counts)}")
            if got is not want:
                raise AssertionError(f"{tag} {name}: the port says {got}, the host tier {want}")
            _need_main(counts, f"{tag} {name}")
            out[name] = dict(seconds=secs, counts=counts)
        got, secs, counts = _run_counted(
            torch, lambda: dev.verify_signature_sets_individual(bad), dev._inner)
        log(f"{tag} verify_signature_sets_individual: invalid at "
            f"{[i for i, ok in enumerate(got) if not ok]} = host tier, {secs:.3f} s; "
            f"bisection {json.dumps(dev._inner.last_bisect)}; launches {json.dumps(counts)}")
        if got != host_bad:
            raise AssertionError(f"{tag} the per-set verdicts differ from the host tier's")
        _need(counts, f"{tag} individual", "K2p", "K3-fe")
        out["individual"] = dict(seconds=secs, counts=counts, **dev._inner.last_bisect)
    finally:
        native.g1_decompress = real
    seen = obs.snapshot()
    log(f"{tag} observer {json.dumps(seen)}; bisections {obs.bisects}; "
        f"G1 decompressions during the verdicts {decompressions['g1']}")
    if decompressions["g1"] != 0:
        raise AssertionError(f"{tag} a pubkey was decompressed: the table did not serve it")
    need = {"planner/root_grouped": 2, "planner/individual": 1,
            "epoch_table/hit": len(sets), "epoch_table/miss": 0}
    for key, n in need.items():
        if seen.get(key, 0) != n:
            raise AssertionError(f"{tag} observer {key} = {seen.get(key, 0)}, expected {n}")
    for key in ("stage/marshal", "stage/rand", "stage/dispatch", "stage/device_wait",
                "stage/bisect", "stage/hash_to_curve", "h2c/hit"):
        if not seen.get(key):
            raise AssertionError(f"{tag} the observer saw no {key}")
    if len(obs.bisects) != 1 or obs.bisects[0][0] <= 0:
        raise AssertionError(f"{tag} expected one bisection with rounds, got {obs.bisects}")
    out["observer"] = seen
    return out


def make_key_sets(np, key_ids, roots, seed: int):
    """Sets signed by key key_ids[i] over roots[i], with the secret keys
    drawn from `seed`, signed by the host tier."""
    from lodestar_tpu_torch import profile_verdict

    sks = profile_verdict.secret_keys(np.random.default_rng(seed), max(key_ids) + 1)
    return profile_verdict.make_key_sets(key_ids, roots, sks, threads=THREADS)


def _wrong_message(sets, k: int, root: bytes):
    """Set k's signing root replaced by a fresh one (its signature no longer
    matches; every root of the batch keeps its count of sets)."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    out[k] = SignatureSet(sets[k].pubkey, root, sets[k].signature)
    return out


def _swap_signatures(sets, i: int, j: int):
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    out[i] = SignatureSet(sets[i].pubkey, sets[i].message, sets[j].signature)
    out[j] = SignatureSet(sets[j].pubkey, sets[j].message, sets[i].signature)
    return out


def _bad_flags(sets, k: int):
    """Set k's signature with its compression flag cleared: it does not
    decode."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    raw = bytearray(sets[k].signature)
    raw[0] &= 0x7F
    out[k] = SignatureSet(sets[k].pubkey, sets[k].message, bytes(raw))
    return out


def _host_after(host, bad, changed):
    """The host tier's per-set verdicts of `bad`: the unchanged sets keep
    those of `host`, the changed ones are verified anew."""
    out = list(host)
    for k, ok in zip(changed, _host_verdicts([bad[k] for k in changed])):
        out[k] = ok
    return out


def _spy_routes(v):
    """Record which submit paths the verifier takes (appended in order)."""
    routes = []
    for name in ("_submit_grouped", "_submit_pk_grouped", "_submit_flat"):
        fn = getattr(v, name)

        def spy(*args, _fn=fn, _name=name[len("_submit_"):]):
            routes.append(_name)
            return _fn(*args)

        setattr(v, name, spy)
    return routes


def _verdict(torch, v, routes, tag, name, sets, want: bool, route: list):
    """One counted verdict: equal to the host tier's, through `route`."""
    routes.clear()
    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v)
    log(f"{tag} {name}: port {got}, host tier {want}, routes {routes}, {secs:.3f} s; "
        f"launches {json.dumps(counts)}; stages {json.dumps(v.stage_seconds)}")
    if got is not want:
        raise AssertionError(f"{tag} {name}: the port says {got}, the host tier {want}")
    if routes != route:
        raise AssertionError(f"{tag} {name}: routes {routes}, expected {route}")
    return secs, counts


PK_KEYS, PK_ROOTS = 128, 32  # the default pk-grouped configuration (128, 32)


def phase_pk_grouped(torch, np):
    """4096 sets over 4096 unique roots from 128 keys: the valid batch and
    three tampered ones through the pk-grouped verdict."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[pk-grouped]"
    n = PK_KEYS * PK_ROOTS
    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    sets = make_key_sets(np, [i // PK_ROOTS for i in range(n)],
                         [rng.bytes(32) for _ in range(n)], SEED + 12)
    host = _host_verdicts(sets)
    log(f"{tag} made {n} sets ({PK_KEYS} keys x {PK_ROOTS} unique roots each) and the host "
        f"tier's verdicts in {time.perf_counter() - t0:.1f} s")
    if not all(host):
        raise AssertionError("the host tier rejects the valid pk-grouped batch")
    v = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED))
    routes = _spy_routes(v)
    out = {}
    secs, counts = _verdict(torch, v, routes, tag, "(a) valid, first call", sets, True,
                            ["pk_grouped"])
    _need(counts, f"{tag} valid", "K4")  # every multiply here is ≥ 4096 products
    _need_main(counts, f"{tag} valid")
    out["cold"] = dict(seconds=secs, counts=counts)
    # a flood of unique roots never hits the hash-to-G2 cache: empty it,
    # so that the warm verdict hashes its 4096 roots as the first did
    v._h2c_cache.clear()
    with _products_per_launch() as products:
        secs, counts = _verdict(torch, v, routes, tag, "(a) valid, warm, hash cache emptied",
                                sets, True, ["pk_grouped"])
    _need(counts, f"{tag} valid (warm)", "K4")
    _need_main(counts, f"{tag} valid (warm)")
    _check_products(products, counts, tag)
    out["warm"] = dict(seconds=secs, counts=counts, stages=dict(v.stage_seconds),
                       products=products)
    log(f"{tag} warm: {n / secs:.1f} sets/s")
    i, j = 5, n // 2 + 3  # sets of two different keys
    for name, bad, changed in (
        ("(b) wrong message", _wrong_message(sets, i, rng.bytes(32)), (i,)),
        ("(c) swapped signature", _swap_signatures(sets, i, j), (i, j)),
        ("(d) bad flag bits", _bad_flags(sets, i), (i,)),
    ):
        want = all(_host_after(host, bad, changed))
        if want:
            raise AssertionError(f"{tag} {name}: the host tier accepts the tampered batch")
        _verdict(torch, v, routes, tag, name, bad, False, ["pk_grouped"])
    return out


def phase_flat(torch, np):
    """128 sets over 128 roots and 128 keys, valid and with one wrong
    message, and 200 such sets (two chunks): the flat verdict."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[flat]"
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    sets = make_key_sets(np, list(range(200)), [rng.bytes(32) for _ in range(200)], SEED + 14)
    host = _host_verdicts(sets)
    log(f"{tag} made 200 sets and the host tier's verdicts in {time.perf_counter() - t0:.1f} s")
    if not all(host):
        raise AssertionError("the host tier rejects the valid flat batch")
    v = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED))
    routes = _spy_routes(v)
    out = {}
    head = sets[:PER_SET_N]
    _verdict(torch, v, routes, tag, "128 valid, first call", head, True, ["flat"])
    secs, counts = _verdict(torch, v, routes, tag, "128 valid, warm", head, True, ["flat"])
    _need(counts, f"{tag} valid", "K1")
    _need_main(counts, f"{tag} valid")
    out["128"] = dict(seconds=secs, counts=counts)
    bad = _wrong_message(head, 9, rng.bytes(32))
    if all(_host_after(host[:PER_SET_N], bad, (9,))):
        raise AssertionError(f"{tag} the host tier accepts the tampered batch")
    _verdict(torch, v, routes, tag, "128, one wrong message", bad, False, ["flat"])
    secs, counts = _verdict(torch, v, routes, tag, "200 valid (chunks of 128 and 72)", sets,
                            True, ["flat"])
    _need_main(counts, f"{tag} 200 valid", verdicts=2)
    out["200"] = dict(seconds=secs, counts=counts)
    return out


def phase_split(torch, np):
    """The two split compositions: 64 sets over 8 shared roots (64 keys)
    plus 64 sets over 64 unique roots from 2 keys (pk-grouped rest) or
    from 64 keys (flat rest); each valid and with one tampered unique-part
    set."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[split]"
    rng = np.random.default_rng(SEED + 15)
    shared_roots = [rng.bytes(32) for _ in range(8)]
    unique_roots = [rng.bytes(32) for _ in range(64)]
    roots = [shared_roots[i // 8] for i in range(64)] + unique_roots
    out = {}
    for rest, keys, route in (("pk-grouped", [64 + i % 2 for i in range(64)], "pk_grouped"),
                              ("flat", [64 + i for i in range(64)], "flat")):
        sets = make_key_sets(np, list(range(64)) + keys, roots, SEED + 16)
        host = _host_verdicts(sets)
        if not all(host):
            raise AssertionError(f"{tag} the host tier rejects the valid batch")
        v = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED))
        routes = _spy_routes(v)
        secs, counts = _verdict(torch, v, routes, tag, f"grouped + {rest}, valid", sets, True,
                                ["grouped", route])
        _need_main(counts, f"{tag} grouped + {rest}", verdicts=2)
        out[rest] = dict(seconds=secs, counts=counts)
        k = 64 + 7  # a set of the unique part
        bad = _wrong_message(sets, k, rng.bytes(32))
        if all(_host_after(host, bad, (k,))):
            raise AssertionError(f"{tag} the host tier accepts the tampered batch")
        _verdict(torch, v, routes, tag, f"grouped + {rest}, one tampered unique set", bad, False,
                 ["grouped", route])
    return out


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
    torch.cuda.init()
    stack_at_start = stack_limit()
    log(f"[env] per-thread stack limit at the start: {stack_at_start} B")
    ptxas = phase_build()
    muls = cuda_tower.fp_muls_per_lane()
    log(f"[build] Fp multiplies per lane (host harness): {json.dumps(muls)}")
    max_err, k1_rows, k1_ptxas = phase_k1(torch, np, ptxas)
    k4_err, k4_rows = phase_k4(torch, np)
    fe_err, fe_rows = phase_fe(torch, np, muls, ptxas)
    k2p_err, k2p_rows = phase_k2p(torch, np, muls, ptxas)
    k2p_row = k2p_rows[K2P_LANES[-1]]
    sets, host_ok, bad, host_bad = per_set_batches(np)
    k3_err, k3_rows = phase_k3(torch, np, muls, ptxas, bad, host_bad)
    k3_row = k3_rows[PER_SET_N]
    k2_err, k2_rows = phase_k2(torch, np, muls, ptxas, stack_at_start)
    k2_row = k2_rows[K2_LANES[-1]]
    grouped_counts, wall, n_sets, grouped_products = phase_slice(torch, np, 64, 64)
    log(f"[slice] main path (64, 64): {wall:.3f} s per {n_sets}-set verdict, "
        f"{n_sets / wall:.1f} sets/s, launches per verdict {json.dumps(grouped_counts)}")
    phase_slice(torch, np, 16, 8)
    pk = phase_pk_grouped(torch, np)
    flat = phase_flat(torch, np)
    split = phase_split(torch, np)
    per_set = phase_per_set(torch, np, sets, host_ok, bad, host_bad)
    checks = phase_pairing_check(torch, np, sets, host_ok, bad, host_bad)
    serve = phase_serve(torch, np)
    log(f"[summary] pk-grouped {PK_KEYS * PK_ROOTS} sets: {pk['warm']['seconds']:.3f} s warm, "
        f"its roots hashed anew ({PK_KEYS * PK_ROOTS / pk['warm']['seconds']:.1f} sets/s), first call "
        f"{pk['cold']['seconds']:.3f} s; flat 128 {flat['128']['seconds']:.3f} s, 200 "
        f"{flat['200']['seconds']:.3f} s; split + pk-grouped {split['pk-grouped']['seconds']:.3f} s, "
        f"split + flat {split['flat']['seconds']:.3f} s")
    log(f"[summary] per-set {PER_SET_N}: bisection valid {per_set['a']['seconds']:.3f} s, "
        f"bisection 3 invalid {per_set['b']['seconds']:.3f} s, K3 route "
        f"{per_set['c']['seconds']:.6f} s; script {time.perf_counter() - t_start:.1f} s")
    log(f"[summary] serve: populate {serve['populate']['rows']} rows "
        f"{serve['populate']['seconds']:.6f} s, warm_h2c {serve['warm_h2c']['hashed']} roots; "
        f"128-set job valid {serve['valid']['seconds']:.3f} s, three bad "
        f"{serve['three bad signatures']['seconds']:.3f} s, per-set "
        f"{serve['individual']['seconds']:.3f} s")
    log(f"[summary] ptxas {json.dumps(ptxas)}")
    log(f"[summary] k1 by products (device and call ms): {json.dumps(k1_rows)}; "
        f"ptxas {json.dumps(k1_ptxas)}")
    log(f"[summary] k4 and k1 by products (device and call ms): {json.dumps(k4_rows)}")
    stack_end = stack_limit()
    log(f"[summary] per-thread stack limit {stack_end} B at the end, {stack_at_start} B at "
        f"the start; the first launches of K3-fe, K2p, K3 and K2 took "
        f"{fe_rows[FE_LANES[0]]['first_launch_bytes']} B, {k2p_row['first_launch_bytes']} B, "
        f"{k3_row['first_launch_bytes']} B and {k2_row['first_launch_bytes']} B")
    if stack_end > stack_at_start:
        raise AssertionError("the per-thread stack limit was raised")
    log(f"[summary] k3-fe by lanes: {json.dumps(fe_rows)}")
    log(f"[summary] k2p by lanes: {json.dumps(k2p_rows)}")
    log(f"[summary] k3 by sets: {json.dumps(k3_rows)}")
    log(f"[summary] k2 by lanes: {json.dumps(k2_rows)}")

    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    k1_mix = launch_mix(torch, np, "k1 main path", grouped_products["K1"],
                        cuda_fp.mont_mul_cuda, cuda_fp.mont_mul_plain, k1_bound)
    k4_mix = launch_mix(torch, np, "k4 main path", pk["warm"]["products"]["K4"],
                        cuda_mxu.mont_mul_mxu_cuda, cuda_mxu.mont_mul_mxu_plain, k4_bound)
    kernels = {"kernels": [
        {
            "name": "mont_mul",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/mont_mul.cu",
            "replaces": "lodestar_tpu/ops/pallas_fp.py:52",
            "launches": grouped_counts["K1"],
            "max_abs_err": max_err,
            "ms": k1_mix["ms"],
            "call_ms": k1_mix["call_ms"],
            "plain_ms": k1_mix["plain_ms"],
            "bound_ms": k1_mix["bound_ms"],
            "bound_by": k1_mix["bound_by"],
            "library_ms": None,
        },
        {
            "name": "mont_mul_mxu",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/mxu_mont.cu",
            "replaces": "lodestar_tpu/ops/pallas_mxu.py:124",
            "launches": pk["warm"]["counts"]["K4"],
            "max_abs_err": k4_err,
            "ms": k4_mix["ms"],
            "call_ms": k4_mix["call_ms"],
            "plain_ms": k4_mix["plain_ms"],
            "bound_ms": k4_mix["bound_ms"],
            "bound_by": k4_mix["bound_by"],
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
            "call_ms": k2_row["call_ms"],
            "rounds": k2_row["rounds"],
            "us_per_round": k2_row["us_per_round"],
            "schedule_fp_muls": k2_row["schedule_fp_muls"],
            "plain_ms": k2_row["plain_ms"],
            "bound_ms": k2_row["bound_ms"],
            "bound_by": k2_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "miller_loop_proj",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:120",
            "serves": "lodestar_tpu/ops/pairing.py:225",
            "launches": grouped_counts["K2p"],
            "max_abs_err": k2p_err,
            "ms": k2p_row["ms"],
            "call_ms": k2p_row["call_ms"],
            "rounds": k2p_row["rounds"],
            "us_per_round": k2p_row["us_per_round"],
            "schedule_fp_muls": k2p_row["schedule_fp_muls"],
            "plain_ms": k2p_row["plain_ms"],
            "bound_ms": k2p_row["bound_ms"],
            "bound_by": k2p_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "final_exp",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:240",
            "serves": "lodestar_tpu/ops/pairing.py:343",
            "launches": grouped_counts["K3-fe"],
            "max_abs_err": fe_err,
            "ms": fe_rows[1]["ms"],
            "call_ms": fe_rows[1]["call_ms"],
            "rounds": fe_rows[1]["rounds"],
            "us_per_round": fe_rows[1]["us_per_round"],
            "schedule_fp_muls": fe_rows[1]["schedule_fp_muls"],
            "plain_ms": fe_rows[1]["plain_ms"],
            "bound_ms": fe_rows[1]["bound_ms"],
            "bound_by": fe_rows[1]["bound_by"],
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
            "call_ms": k3_row["call_ms"],
            "rounds": k3_row["rounds"],
            "us_per_round": k3_row["us_per_round"],
            "schedule_fp_muls": k3_row["schedule_fp_muls"],
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
