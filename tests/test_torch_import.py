"""The port stands alone: importing `lodestar_tpu_torch` and every one of
its modules loads neither JAX nor any module of the JAX package (nor does
importing the serving seams alone: the facade and the epoch table), and
the verifier's entry points do not fall back to the CPU unasked."""

import json
import os
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
                 "observability.stages"):
        assert f"lodestar_tpu_torch.{name}" in result["modules"]


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
