"""The port stands alone: importing `lodestar_tpu_torch` and every one of
its modules loads neither JAX nor any module of the JAX package (nor does
importing the serving seams alone: the facade and the epoch table, nor
the observability modules alone, nor the serving stack alone, nor the
lifecycle spans and the library store alone, nor a spawned mesh worker), no module of it reads a `LODESTAR_TPU_*` variable
(the serving stack's none at all), and the verifier's entry points do
not fall back to the CPU unasked."""

import glob
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

PROBE = r"""
import importlib, json, pkgutil, sys
import lodestar_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("ops.fp", "ops.cuda_fp", "ops.cuda_mxu", "ops.cuda_tower", "ops.pairing",
                 "ops.g2_decompress", "parallel.verifier", "native", "convert", "build",
                 "device", "gen_tower_consts", "chain.bls_verifier", "parallel.epoch_table",
                 "observability.stages", "observability.trace",
                 "observability.flight_recorder", "observability.compile_ledger",
                 "observability.device_ledger", "observability.stage_profile",
                 "observability.runtime", "observability.spans", "ops.aot_store",
                 "metrics.registry", "parallel.mesh",
                 "parallel.mesh_pool", "parallel.sharded", "parallel.fleet",
                 "parallel.fleet_host") + SERVING_MODULES:
        assert f"lodestar_tpu_torch.{name}" in result["modules"]


# the serving stack's modules: none reads any environment variable at all
SERVING_MODULES = ("utils.retry", "metrics.bls", "metrics.server", "chain.supervisor",
                   "chain.dispatcher", "observability.slo", "observability.spans",
                   "ops.aot_store", "node.bls_stack", "warmup")

SERVING_PROBE = r"""
import json, sys
import lodestar_tpu_torch.node.bls_stack
import lodestar_tpu_torch.metrics.server
import lodestar_tpu_torch.warmup
from lodestar_tpu_torch.observability import slo
slo.load_rules()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps(bad))
"""


def test_serving_stack_loads_no_jax_and_reads_no_environment():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SERVING_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for name in SERVING_MODULES + ("chain.bls_verifier",):
        path = os.path.join(REPO, "lodestar_tpu_torch", *name.split(".")) + ".py"
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\b(environ|getenv|putenv)\b", text), path


SEAMS_PROBE = r"""
import json, sys
import lodestar_tpu_torch.chain.bls_verifier
import lodestar_tpu_torch.parallel.epoch_table
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps(bad))
"""


def test_serving_seams_load_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SEAMS_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


OBSERVABILITY_PROBE = r"""
import json, sys
import lodestar_tpu_torch.metrics.registry
import lodestar_tpu_torch.observability.stages
import lodestar_tpu_torch.observability.trace
import lodestar_tpu_torch.observability.flight_recorder
import lodestar_tpu_torch.observability.compile_ledger
import lodestar_tpu_torch.observability.device_ledger
import lodestar_tpu_torch.observability.stage_profile
import lodestar_tpu_torch.observability.runtime
import lodestar_tpu_torch.observability.spans
from lodestar_tpu_torch.observability import default_pipeline
default_pipeline().registry.expose()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps(bad))
"""


SPANS_AOT_PROBE = r"""
import json, sys
import lodestar_tpu_torch.observability.spans
import lodestar_tpu_torch.ops.aot_store
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps(bad))
"""


def test_spans_and_library_store_load_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SPANS_AOT_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_observability_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", OBSERVABILITY_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


WORKER_PROBE = r"""
import json, sys
from lodestar_tpu_torch.parallel.mesh_pool import MeshPool

def bad(names):
    return sorted(m for m in names
                  if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
                  or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))

if __name__ == "__main__":
    pool = MeshPool(["cpu"])
    try:
        worker = pool.modules()[0]
    finally:
        pool.close()
    print(json.dumps({"parent": bad(sys.modules), "worker": bad(worker),
                      "sharded": "lodestar_tpu_torch.parallel.sharded" in worker}))
"""


def test_mesh_worker_loads_no_jax_and_no_jax_package(tmp_path):
    # a spawned worker imports the pool's modules and `parallel/sharded.py`
    script = tmp_path / "probe.py"
    script.write_text(WORKER_PROBE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, str(script)], cwd=REPO, env=env,
        capture_output=True, text=True, check=True, timeout=300,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"parent": [], "worker": [], "sharded": True}


def test_no_module_reads_a_lodestar_tpu_variable():
    sources = glob.glob(os.path.join(REPO, "lodestar_tpu_torch", "**", "*.py"), recursive=True)
    assert len(sources) > 30
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not re.search(r"(environ|getenv)\b[^\n]*LODESTAR_TPU_", text), path


def test_verifier_without_a_device_does_not_run_on_the_cpu():
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves to it")
    from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
    from lodestar_tpu_torch.parallel.epoch_table import EpochPubkeyTable

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBlsVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBlsVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EpochPubkeyTable()
    assert TorchBlsVerifier(device="cpu").device.type == "cpu"
    assert DeviceBlsVerifier(device="cpu")._inner._epoch_table.device.type == "cpu"
