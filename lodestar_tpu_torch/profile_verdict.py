"""Where a root-grouped verdict spends its time on the GPU.

    python3 -m lodestar_tpu_torch.profile_verdict [--roots 64] [--per-root 64]

Makes `roots × per_root` signature sets from a fixed seed with the host
tier (distinct keys, one signing root per row), warms a `TorchBlsVerifier`
up on them, then measures one verdict three ways:

1. stages: host clock around each stage of `grouped_verify_kernel_raw`
   with a CUDA synchronise on both sides and the K1 launches in each
   stage; then, in a second pass, the PyTorch operations each dispatches;
2. profiler: `torch.profiler` over one whole verdict — kernel time by
   kernel and by PyTorch operation, K1's share, and the device's busy
   share of the (profiled) wall clock;
3. the plain wall clock of one verdict with nothing attached.

Prints one line per measurement and writes them all as JSON to `--out`
(default build/lodestar_tpu_torch/profile_verdict.json). Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 20261017


def make_sets(n_roots: int, per_root: int, seed: int = SEED, threads: int | None = None):
    """n_roots × per_root signature sets: distinct random keys, random
    32-byte signing roots, signatures from the host tier."""
    from . import native
    from .bls.api import DST_G2, PublicKey, SignatureSet
    from .bls.fields import R

    rng = np.random.default_rng(seed)
    roots = [rng.bytes(32) for _ in range(n_roots)]
    n = n_roots * per_root
    sks = [(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1).to_bytes(32, "big")
           for _ in range(n)]
    msgs = [roots[i // per_root] for i in range(n)]

    def one(i):
        rc1, pk = native.sk_to_pk(sks[i])
        rc2, sig = native.sign(sks[i], msgs[i], DST_G2)
        if rc1 or rc2:
            raise RuntimeError("host tier failed to make a set")
        return SignatureSet(PublicKey(pk), msgs[i], sig)

    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        return list(pool.map(one, range(n)))


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--per-root", type=int, default=64)
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_verdict.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_verdict: no CUDA device")

    from .ops import cuda_fp
    from .parallel.verifier import (
        TorchBlsVerifier,
        _rand_pairs,
        grouped_verify_kernel_raw,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report: dict = {"card": card, "roots": args.roots, "per_root": args.per_root}
    print("card:", card, flush=True)

    sets = make_sets(args.roots, args.per_root)
    v = TorchBlsVerifier(device="cuda", grouped_configs=((16, 8), (64, 64)),
                         rng=np.random.default_rng(SEED))
    if v.verify_signature_sets(sets) is not True:
        raise AssertionError("the valid batch was rejected")

    plan = v._plan_groups(sets)
    g, sig_raw = v._marshal_grouped(sets, plan)
    a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(SEED))
    dev = v.device
    inputs = [torch.as_tensor(x).to(dev) for x in
              (g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)]

    # 1. stages, synchronised: one pass timed, one pass counting the
    # PyTorch operations dispatched (the counter slows the dispatch)
    stages: dict[str, dict] = {}

    class Stage:
        count = False

        def __init__(self, name):
            self.name = name
            self.counter = _OpCounter()

        def __enter__(self):
            torch.cuda.synchronize()
            self.launches = cuda_fp.LAUNCHES
            if self.count:
                self.counter.__enter__()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            secs = time.perf_counter() - self.t0
            row = stages.setdefault(self.name, {})
            if self.count:
                self.counter.__exit__(*exc)
                row["torch_ops"] = self.counter.ops
            else:
                row["seconds"] = secs
                row["k1_launches"] = cuda_fp.LAUNCHES - self.launches

    class CountingStage(Stage):
        count = True

    t0 = time.perf_counter()
    ok = bool(grouped_verify_kernel_raw(*inputs, stage=Stage))
    report["staged_wall_s"] = time.perf_counter() - t0
    ok &= bool(grouped_verify_kernel_raw(*inputs, stage=CountingStage))
    if not ok:
        raise AssertionError("the valid batch was rejected (staged runs)")
    report["stages"] = stages
    for name, row in stages.items():
        print(f"stage {name}: {row['seconds']:.4f} s, {row['torch_ops']} torch ops, "
              f"{row['k1_launches']} K1 launches", flush=True)

    # 2. the profiler over one verdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bool(grouped_verify_kernel_raw(*inputs))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels are the events on the device; an aten operation's device time
    # is that of the kernels it launched, so count each kernel once
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total_dev_us = sum(device_us(e) for e in kernels)
    k1_us = sum(device_us(e) for e in kernels if "mont_mul" in e.key)
    report["profiled_wall_s"] = prof_wall
    report["device_time_s"] = total_dev_us / 1e6
    report["k1_device_time_s"] = k1_us / 1e6
    report["device_busy_share"] = total_dev_us / 1e6 / prof_wall
    report["top_kernels"] = [
        {"name": e.key, "device_ms": device_us(e) / 1e3, "calls": e.count}
        for e in sorted(kernels, key=device_us, reverse=True)[:12]
    ]
    ops = [e for e in events if e.device_type != DeviceType.CUDA and device_us(e) > 0]
    report["top_ops"] = [
        {"name": e.key, "device_ms": device_us(e) / 1e3, "calls": e.count}
        for e in sorted(ops, key=device_us, reverse=True)[:12]
    ]
    print(f"profiled verdict: wall {prof_wall:.3f} s, kernel time "
          f"{total_dev_us / 1e6:.3f} s in {sum(e.count for e in kernels)} launches "
          f"(K1 {k1_us / 1e6:.4f} s), busy share {report['device_busy_share']:.4f}",
          flush=True)
    for title in ("top_kernels", "top_ops"):
        print(title + ":", flush=True)
        for row in report[title]:
            print(f"  {row['device_ms']:10.3f} ms  {row['calls']:7d}  {row['name'][:90]}",
                  flush=True)

    # 3. plain wall clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bool(grouped_verify_kernel_raw(*inputs))
    report["plain_wall_s"] = time.perf_counter() - t0
    print(f"plain verdict wall {report['plain_wall_s']:.3f} s", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
