"""The JAX check: top-level names compared whole, and a run that cannot
find a card exits non-zero with no result."""

import os
import subprocess
import sys
import types

from bm import harness

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setitem(sys.modules, "lodestar_tpu_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", types.ModuleType("y"))
    for name in ("jax", "jaxlib", "flax", "lodestar_tpu"):
        if name in sys.modules:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lodestar_tpu.bls", types.ModuleType("z"))
    assert harness.forbidden_modules() == ["lodestar_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "lodestar_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; from bm import harness, standins, compare; "
            "import lodestar_tpu_torch.node.bls_stack; print(harness.forbidden_modules())"
            % (os.path.dirname(RUN), os.path.dirname(os.path.dirname(RUN))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, RUN, "--workload", "att-committees-64", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
