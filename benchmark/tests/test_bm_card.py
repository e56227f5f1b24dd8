"""A short run of each cell on the card: the benchmark's command, a few
seconds of window, `correct` true and the cell's metrics all there."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on a machine with the card")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["att-committees-64", "blocks-full-131"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 77), "--seconds", "25", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    group = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
