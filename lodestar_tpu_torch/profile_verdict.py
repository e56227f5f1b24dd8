"""Where a grouped batch verdict spends its time on the GPU.

    python3 -m lodestar_tpu_torch.profile_verdict [--path grouped] [--rows 64] [--lanes 64]
    python3 -m lodestar_tpu_torch.profile_verdict --path pk-grouped --rows 128 --lanes 32
    python3 -m lodestar_tpu_torch.profile_verdict --lane-rule-ab

Makes `rows × lanes` signature sets from a fixed seed with the host tier:
for `grouped`, distinct keys with one signing root per row; for
`pk-grouped`, one key per row with a unique root per set. Warms a
`TorchBlsVerifier` up on them, then measures one verdict of the path's
kernel (`grouped_verify_kernel_raw` or `pk_grouped_verify_kernel_raw`)
three ways:

1. stages: host clock around each stage of the kernel with a CUDA
   synchronise on both sides and the K1, K4, K2p and K3-fe launches in
   each stage;
   then, in a second pass, the PyTorch operations each dispatches;
2. profiler: `torch.profiler` over one whole verdict — kernel time by
   kernel and by PyTorch operation, K1's, K4's, K2p's and K3-fe's shares,
   and the device's busy share of the (profiled) wall clock;
3. the plain wall clock of one verdict with nothing attached.

With `--lane-rule-ab` it measures instead the whole warm verdict
(`verify_signature_sets`) eight times in the balanced order A B B A B A A
B: A with `fp.mul`'s lane rule (K4 from 4096 products up), B with every
multiply on K1, as before the rule (`cuda_mxu.MIN_LANES` raised for the
call).

Prints one line per measurement and writes them all as JSON to `--out`
(default build/lodestar_tpu_torch/profile_<path>.json). Needs a GPU.
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


def secret_keys(rng, n: int) -> list[bytes]:
    """n random BLS secret keys (32 B big-endian) from a numpy Generator."""
    from .bls.fields import R

    return [(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1).to_bytes(32, "big")
            for _ in range(n)]


def make_sets(n_roots: int, per_root: int, seed: int = SEED, threads: int | None = None):
    """n_roots × per_root signature sets: distinct random keys, random
    32-byte signing roots, signatures from the host tier."""
    rng = np.random.default_rng(seed)
    roots = [rng.bytes(32) for _ in range(n_roots)]
    n = n_roots * per_root
    return make_key_sets(list(range(n)), [roots[i // per_root] for i in range(n)],
                         secret_keys(rng, n), threads)


def make_key_sets(key_ids, roots, sks, threads: int | None = None):
    """Sets signed by secret key sks[key_ids[i]] over roots[i], with the
    host tier."""
    from . import native
    from .bls.api import DST_G2, PublicKey, SignatureSet

    def pk(sk):
        rc, out = native.sk_to_pk(sk)
        if rc:
            raise RuntimeError("host tier failed to make a key")
        return PublicKey(out)

    def one(i):
        rc, sig = native.sign(sks[key_ids[i]], roots[i], DST_G2)
        if rc:
            raise RuntimeError("host tier failed to make a set")
        return SignatureSet(pks[key_ids[i]], roots[i], sig)

    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        pks = list(pool.map(pk, sks))
        return list(pool.map(one, range(len(key_ids))))


def make_pk_sets(n_keys: int, per_key: int, seed: int = SEED, threads: int | None = None):
    """n_keys × per_key signature sets: each key signs per_key random
    32-byte roots, every root unique."""
    rng = np.random.default_rng(seed)
    n = n_keys * per_key
    roots = [rng.bytes(32) for _ in range(n)]
    return make_key_sets([i // per_key for i in range(n)], roots, secret_keys(rng, n_keys),
                         threads)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("grouped", "pk-grouped"), default="grouped")
    ap.add_argument("--rows", type=int, default=None,
                    help="roots (grouped) or keys (pk-grouped); default 64 or 128")
    ap.add_argument("--lanes", type=int, default=None,
                    help="sets per row; default 64 or 32")
    ap.add_argument("--lane-rule-ab", action="store_true",
                    help="time warm verdicts with the lane rule against K1 only, in turns")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_verdict: no CUDA device")
    grouped = args.path == "grouped"
    rows = args.rows or (64 if grouped else 128)
    lanes = args.lanes or (64 if grouped else 32)
    out_path = args.out or (f"build/lodestar_tpu_torch/profile_{args.path}"
                            f"{'_ab' if args.lane_rule_ab else ''}.json")

    from .ops import cuda_fp, cuda_mxu, cuda_tower
    from .parallel.verifier import (
        TorchBlsVerifier,
        _rand_pairs,
        grouped_verify_kernel_raw,
        pk_grouped_verify_kernel_raw,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report: dict = {"card": card, "path": args.path, "rows": rows, "lanes": lanes}
    print("card:", card, flush=True)

    if grouped:
        sets = make_sets(rows, lanes)
        v = TorchBlsVerifier(device="cuda", grouped_configs=((16, 8), (rows, lanes)),
                             rng=np.random.default_rng(SEED))
        g, sig_raw = v._marshal_grouped(sets, v._plan_groups(sets))
        kernel = grouped_verify_kernel_raw
    else:
        sets = make_pk_sets(rows, lanes)
        v = TorchBlsVerifier(device="cuda", pk_grouped_configs=((rows, lanes),),
                             rng=np.random.default_rng(SEED))
        g, sig_raw = v._marshal_pk_grouped(sets, v._plan_pk_groups(sets))
        kernel = pk_grouped_verify_kernel_raw
    if v.verify_signature_sets(sets) is not True:
        raise AssertionError("the valid batch was rejected")
    if args.lane_rule_ab:
        report["lane_rule_ab"] = lane_rule_ab(v, sets)
        return _write(report, out_path)

    a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(SEED))
    dev = v.device
    inputs = [torch.as_tensor(x).to(dev) for x in
              (g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)]

    # 1. stages, synchronised: one pass timed, one pass counting the
    # PyTorch operations dispatched (the counter slows the dispatch)
    stages: dict[str, dict] = {}

    def launches():
        return {"k1_launches": cuda_fp.LAUNCHES, "k4_launches": cuda_mxu.LAUNCHES,
                "k2p_launches": cuda_tower.MILLER_PROJ_LAUNCHES,
                "k3fe_launches": cuda_tower.FINAL_EXP_LAUNCHES}

    class Stage:
        count = False

        def __init__(self, name):
            self.name = name
            self.counter = _OpCounter()

        def __enter__(self):
            torch.cuda.synchronize()
            self.launches = launches()
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
                row.update({k: n - self.launches[k] for k, n in launches().items()})

    class CountingStage(Stage):
        count = True

    t0 = time.perf_counter()
    ok = bool(kernel(*inputs, stage=Stage))
    report["staged_wall_s"] = time.perf_counter() - t0
    ok &= bool(kernel(*inputs, stage=CountingStage))
    if not ok:
        raise AssertionError("the valid batch was rejected (staged runs)")
    report["stages"] = stages
    for name, row in stages.items():
        print(f"stage {name}: {row['seconds']:.4f} s, {row['torch_ops']} torch ops, "
              f"{row['k1_launches']} K1, {row['k4_launches']} K4, {row['k2p_launches']} K2p "
              f"and {row['k3fe_launches']} K3-fe launches", flush=True)

    # 2. the profiler over one verdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bool(kernel(*inputs))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels are the events on the device; an aten operation's device time
    # is that of the kernels it launched, so count each kernel once
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total_dev_us = sum(device_us(e) for e in kernels)
    k1_us = sum(device_us(e) for e in kernels if "mont_mul_kernel" in e.key)
    k4_us = sum(device_us(e) for e in kernels if "mxu_mont_kernel" in e.key)
    k2p_us = sum(device_us(e) for e in kernels if "miller_proj_kernel" in e.key)
    k3fe_us = sum(device_us(e) for e in kernels if "final_exp_kernel" in e.key)
    report["profiled_wall_s"] = prof_wall
    report["device_time_s"] = total_dev_us / 1e6
    report["k1_device_time_s"] = k1_us / 1e6
    report["k4_device_time_s"] = k4_us / 1e6
    report["k2p_device_time_s"] = k2p_us / 1e6
    report["k3fe_device_time_s"] = k3fe_us / 1e6
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
          f"(K1 {k1_us / 1e6:.4f} s, K4 {k4_us / 1e6:.4f} s, K2p {k2p_us / 1e6:.4f} s, "
          f"K3-fe {k3fe_us / 1e6:.4f} s), busy share {report['device_busy_share']:.4f}",
          flush=True)
    for title in ("top_kernels", "top_ops"):
        print(title + ":", flush=True)
        for row in report[title]:
            print(f"  {row['device_ms']:10.3f} ms  {row['calls']:7d}  {row['name'][:90]}",
                  flush=True)

    # 3. plain wall clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bool(kernel(*inputs))
    report["plain_wall_s"] = time.perf_counter() - t0
    print(f"plain verdict wall {report['plain_wall_s']:.3f} s", flush=True)
    return _write(report, out_path)


def lane_rule_ab(v, sets) -> list[dict]:
    """Warm verdicts in the order A B B A B A A B: A with the lane rule,
    B with every multiply on K1. One row per verdict: arm, seconds, K1
    and K4 launches."""
    from .ops import cuda_fp, cuda_mxu

    rule = cuda_mxu.MIN_LANES
    rows = []
    for arm in "ABBABAAB":
        cuda_mxu.MIN_LANES = rule if arm == "A" else 1 << 62
        try:
            torch.cuda.synchronize()
            k1, k4 = cuda_fp.LAUNCHES, cuda_mxu.LAUNCHES
            t0 = time.perf_counter()
            ok = v.verify_signature_sets(sets)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            cuda_mxu.MIN_LANES = rule
        row = {"arm": "lane_rule" if arm == "A" else "k1_only", "seconds": secs,
               "k1_launches": cuda_fp.LAUNCHES - k1, "k4_launches": cuda_mxu.LAUNCHES - k4}
        if ok is not True or (arm == "B" and row["k4_launches"]):
            raise AssertionError(f"A/B verdict {row}: rejected, or K4 ran with K1 only")
        rows.append(row)
        print(f"A/B {row['arm']}: {secs:.3f} s, K1 {row['k1_launches']}, "
              f"K4 {row['k4_launches']} launches", flush=True)
    for arm in ("lane_rule", "k1_only"):
        secs = sorted(r["seconds"] for r in rows if r["arm"] == arm)
        print(f"A/B {arm}: median {(secs[1] + secs[2]) / 2:.3f} s of {secs}", flush=True)
    return rows


def _write(report: dict, out_path: str) -> int:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
