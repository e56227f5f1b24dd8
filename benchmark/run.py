"""The benchmark of `lodestar_tpu_torch`'s BLS serving stack on the card.

    python3 benchmark/run.py --workload att-committees-64 --seed 7 --seconds 51 --trace 0

Runs one cell of `BENCHMARK.json` from the root of a checkout and prints
its result as the last line of standard output: the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`, whether
every verdict of the window was the reference's (`correct`), and the
numbers that decided it with their limits (also the last lines of
standard error). Exits non-zero, printing no result, without enough CUDA
devices, with a file of the cell missing, or when JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHES = os.path.join(ROOT, "build", "benchmark")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CACHES, sub)


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches()
    sys.path[:0] = [ROOT, HERE]
    from bm import harness

    try:
        cell = harness.Cell(args.workload)
    except (harness.CellError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result, lines = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                                T_PROCESS).execute()
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
