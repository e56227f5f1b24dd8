"""The control of the check that decides `correct`: the cell's traffic
served by the reference with one of the configuration's guarantees broken
(`bm/standins.py` `ControlStack`, the kind named by the traffic file's
`control`), judged by the same comparison as the benchmark's runs. Every
seed has to come out not correct. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload att-committees-64 --seeds 11,12,13 --seconds 51

Prints one JSON line per seed: the numbers compared, with their limits.
Needs no card: the reference runs on the host.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_control(cell, seed: int, seconds: float, log=None) -> dict:
    """The control's result for one seed."""
    from bm import bls_ref, harness, standins

    kind = cell.traffic["control"]
    ref = bls_ref.Reference(random.Random(f"control:{seed}"))
    run = harness.Run(cell, seed, seconds, False, time.perf_counter(),
                      stack_factory=lambda: standins.ControlStack(kind, ref), log=log)
    result, _ = run.execute()
    return {"seed": seed, "control": kind, "correct": result["correct"],
            "attempted": result["attempted"], "check": result["check"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    from bm import harness

    cell = harness.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run_control(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
