"""Where the benchmark finds its files and keeps what it builds: every
path is inside the checkout, fixed, and never made from a process id, a
temporary name or the time."""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
BUILD_DIR = os.path.join(ROOT, "build", "benchmark")


def config_file(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", f"{name}.json")


def traffic_file(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def metric_file(name: str) -> str:
    """A metric's reader: `metrics/<name>.py` where there is one, else the
    reader of its base name, the part before the first dot, which serves
    every cell that reports the quantity (`dispatch_s.att` and
    `dispatch_s.block` both read `metrics/dispatch_s.py`)."""
    own = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if os.path.exists(own):
        return own
    return os.path.join(BENCH_DIR, "metrics", f"{name.split('.', 1)[0]}.py")


def benchmark_json() -> str:
    return os.path.join(ROOT, "BENCHMARK.json")
