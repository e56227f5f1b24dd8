"""Where one lane of K3-fe, the final exponentiation with a warp per lane,
spends its cycles on the GPU, by operation.

    python3 -m lodestar_tpu_torch.profile_fe [--reps 32] [--out PATH]

Builds the probe `csrc/fe_probe.cu` (not on the port's path) over the
kernel's own `csrc/tower_warp.cuh`, runs it on one warp over a random lane
made from a fixed seed, and checks that the lane it computes equals
K3-fe's. The probe times each tower operation `--reps` times in a row and
the whole lane once, in SM cycles; one thread alone times the Fp multiply
(the warp schedule's FIOS and `fp_mont.cuh`'s CIOS), the Fp addition and
the Euclid inverse. Each operation's share of the lane is its cycles times
its count per lane (`lane_op_counts`) over the lane's cycles. The probe
runs twice.

Prints one line per measurement and writes them all as JSON to `--out`
(default build/lodestar_tpu_torch/profile_fe.json). Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .ops.pairing import X_ABS

SEED = 20261017

# the order of fe_probe.cu's cycles[]
PROBE_FIELDS = ("fp_mul_fios", "fp_mul_cios", "fp_add", "cyclotomic_sqr", "fp12_mul",
                "frobenius", "conj", "fp12_inv", "euclid", "lane", "keep")

# tower_warp.cuh's `program` after the inversion: five powers by |x|, ten
# Fp12 products, three Frobenius maps and seven conjugations
_POWS, _MULS, _FROBS, _CONJS = 5, 10, 3, 7


def lane_op_counts() -> dict[str, int]:
    """How many times one lane runs each operation: a power by |x| is a
    copy, then a cyclotomic squaring per bit after the leading one and an
    Fp12 product per set bit among them; a copy costs what a conjugation
    does."""
    bits = X_ABS.bit_length() - 1
    ones = bin(X_ABS).count("1") - 1
    return {"cyclotomic_sqr": _POWS * bits, "fp12_mul": _MULS + _POWS * ones,
            "frobenius": _FROBS, "conj": _CONJS + _POWS, "fp12_inv": 1}


def _lane(seed: int) -> np.ndarray:
    """One (1, 2, 3, 2, 32) lane of random Fp values in [0, 2p)."""
    from .bls.fields import P
    from .ops.limbs import int_to_limbs

    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(12)]
    return np.stack([int_to_limbs(v) for v in vals]).reshape(1, 2, 3, 2, 32).astype(np.int32)


def probe(fs: torch.Tensor, reps: int) -> tuple[torch.Tensor, dict[str, int]]:
    """Run the probe on the CUDA lane `fs` → (its final exponentiation,
    {field: cycles})."""
    from . import build

    lib = build.fe_probe_cuda()
    lib.lodestar_fe_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.lodestar_fe_probe.restype = ctypes.c_int
    out = torch.empty_like(fs)
    cycles = torch.zeros(len(PROBE_FIELDS), dtype=torch.int64, device=fs.device)
    stream = torch.cuda.current_stream(fs.device).cuda_stream
    rc = lib.lodestar_fe_probe(fs.data_ptr(), out.data_ptr(), cycles.data_ptr(), reps, stream)
    if rc != 0:
        raise RuntimeError(f"fe_probe launch failed: CUDA error {rc}")
    return out, dict(zip(PROBE_FIELDS, cycles.cpu().tolist()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_fe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_fe: no CUDA device")

    from . import build
    from .ops import cuda_tower

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("card:", card, flush=True)
    fs = torch.as_tensor(_lane(SEED)).cuda()
    want = cuda_tower.final_exp_cuda(fs)
    counts = lane_op_counts()
    rounds = cuda_tower.fp_muls_per_lane()["final_exp_warp_rounds"]
    report: dict = {"card": card, "reps": args.reps, "counts": counts, "rounds": rounds,
                    "runs": []}
    for run in range(2):
        got, cyc = probe(fs, args.reps)
        if not bool((got == want).all()):
            raise AssertionError("the probe's lane differs from K3-fe's")
        lane = cyc["lane"]
        each = {k: cyc[k] / args.reps for k in PROBE_FIELDS if k not in ("lane", "keep")}
        share = {k: each[k] * n / lane for k, n in counts.items()}
        report["runs"].append({"cycles": cyc, "each": each, "share": share})
        print(f"run {run}: lane {lane} cycles", flush=True)
        for k, n in counts.items():
            print(f"  {k}: {each[k]:.1f} cycles each, {n} per lane, {share[k]:.4f} of the lane",
                  flush=True)
        print(f"  shares summed: {sum(share.values()):.4f}", flush=True)
        for k in ("fp_mul_fios", "fp_mul_cios", "fp_add", "euclid"):
            print(f"  {k} on one thread: {each[k]:.1f} cycles each", flush=True)
        print(f"  the {rounds} rounds' FIOS multiplies alone: "
              f"{rounds * each['fp_mul_fios'] / lane:.4f} of the lane", flush=True)
    if "fe_probe" in build.BUILD_LOG:
        secs, text = build.BUILD_LOG["fe_probe"]
        report["build_s"] = secs
        report["ptxas"] = build.ptxas_summary(text)
        print("ptxas:", json.dumps(report["ptxas"]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
