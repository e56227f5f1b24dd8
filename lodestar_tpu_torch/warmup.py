"""The warm-boot ladder of the port (the JAX package's
`tools/warmup.py:74` `warm_production`, without XLA):

    python3 -m lodestar_tpu_torch.warmup [--device cuda]

It preloads the libraries of the ahead-of-time store
(`compile_ledger.preload_aot`: each verified and opened, each kernel
launched once on one lane; `timeline().mark("aot_load")`), builds what
the store could not give (`build.py`, cached by source digest under
`build/lodestar_tpu_torch/`), then runs one verdict per production shape
on synthetic sets signed by the host tier, each rung a
`timeline().mark("rung_...")`:

- per-set buckets 4, 16, 64 and 128: the flat batch verdict, the
  bisection verdict with one bad set (its tree and its probes) and the
  exact per-set route (K3);
- grouped 16 × 8 and 64 × 64, pk-grouped 128 × 32;
- the epoch table's device gather.

`main()` builds the whole serving stack with the ladder
(`node.bls_stack.build_bls_stack(warm=True)`), marks `serving_ready`,
closes it and prints one JSON line: the timeline's marks (seconds since
process start), `serving_ready_seconds`, the preload's summary (each
library's store outcome and load seconds, each kernel's first-launch
seconds), the build seconds per library, the peak device memory and each
rung's seconds. What the port persists ahead of time is its libraries; a
CUDA graph lives inside one process and is made anew by each.
"""

from __future__ import annotations

import argparse
import json
import time

RUNGS = ("bucket_4", "bucket_16", "bucket_64", "bucket_128", "grouped_16x8",
         "grouped_64x64", "pk_grouped_128x32", "epoch_table")
SEED = 20261017


def build_extensions(device) -> dict[str, float]:
    """Load or build every library the device needs, all at once; returns
    the seconds each took (a cached build is a load)."""
    from concurrent.futures import ThreadPoolExecutor

    from . import build

    libs = {"bls12_host": build.host_tier}
    if device.type == "cuda":
        libs.update(mont_mul=build.mont_mul_cuda, tower=build.tower_cuda,
                    mxu_mont=build.mxu_cuda)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libs)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in libs.items()}
        return {name: f.result() for name, f in futs.items()}


def _bad_at(sets, k: int):
    """The sets with set k carrying set k+1's signature (invalid)."""
    from .bls.api import SignatureSet

    out = list(sets)
    nxt = sets[(k + 1) % len(sets)]
    out[k] = SignatureSet(sets[k].pubkey, sets[k].message, nxt.signature)
    return out


def _expect(name: str, got, want) -> None:
    if got != want:
        raise RuntimeError(f"warm-boot rung {name}: verdict {got}, expected {want}")


def warm_production(verifier, rungs=None) -> dict:
    """Run the ladder on a `TorchBlsVerifier` (its caches and the compile
    ledger warm as serving would warm them); returns seconds per rung.
    Raises if a rung's verdict is not the expected one."""
    import torch

    from .observability.compile_ledger import timeline
    from .parallel.epoch_table import ROW_WIDTH, EpochPubkeyTable
    from .observability.stages import NULL_OBSERVER
    from .profile_verdict import make_pk_sets, make_sets

    rungs = RUNGS if rungs is None else tuple(rungs)
    unknown = set(rungs) - set(RUNGS)
    if unknown:
        raise ValueError(f"unknown warm-boot rungs {sorted(unknown)}")
    dev = verifier.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    tl = timeline()
    tl.mark("warmup_start")
    for rung in rungs:
        t0 = time.perf_counter()
        if rung.startswith("bucket_"):
            n = int(rung.split("_")[1])
            sets = make_sets(n, 1, seed=SEED + n)
            bad = _bad_at(sets, n // 2)
            _expect(rung, verifier.verify_signature_sets(sets), True)
            want = [i != n // 2 for i in range(n)]
            _expect(rung, verifier.verify_signature_sets_individual(bad), want)
            exact = verifier.verify_individual(verifier._marshal(bad))
            _expect(rung, [bool(v) for v in exact.cpu()[:n]], want)
        elif rung.startswith("grouped_"):
            rows, lanes = (int(x) for x in rung.split("_")[1].split("x"))
            sets = make_sets(rows, lanes, seed=SEED + rows)
            _expect(rung, verifier.verify_signature_sets(sets), True)
        elif rung.startswith("pk_grouped_"):
            keys, per_key = (int(x) for x in rung.split("_")[2].split("x"))
            sets = make_pk_sets(keys, per_key, seed=SEED + keys)
            _expect(rung, verifier.verify_signature_sets(sets), True)
        else:  # epoch_table: the device gather a post-restart epoch runs first
            import numpy as np

            table = EpochPubkeyTable(epochs=1, max_rows=8, observer=NULL_OBSERVER, device=dev)
            table.populate(0, [(bytes([i]) * 48, np.zeros(ROW_WIDTH, np.int32))
                               for i in range(4)])
            gathered = table.gather_device(0, np.arange(4))
            _expect(rung, gathered is not None and tuple(gathered.shape), (4, ROW_WIDTH))
        sync()
        out[rung] = time.perf_counter() - t0
        tl.mark(f"rung_{rung}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device of the verifier (default: the GPU; raises without one)")
    ap.add_argument("--rungs", default=",".join(RUNGS),
                    help="comma-separated subset of the ladder (default: all of it)")
    args = ap.parse_args(argv)
    import torch

    from .device import resolve_device
    from .node.bls_stack import build_bls_stack
    from .observability.compile_ledger import ledger, timeline

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    preload = ledger().preload_aot(device=device)
    build_s = build_extensions(device)
    timeline().mark("extensions_ready")
    stack = build_bls_stack(device=device, warm=True, rungs=args.rungs.split(","))
    try:
        snap = timeline().snapshot()
        doc = {
            "device": str(device),
            "marks": {m["phase"]: m["t_s"] for m in snap["marks"]},
            "serving_ready_seconds": snap["serving_ready_s"],
            "preload": preload,
            "build_seconds": build_s,
            "rung_seconds": stack.ladder,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
        }
    finally:
        stack.close()
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
