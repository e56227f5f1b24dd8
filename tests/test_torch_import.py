"""The port stands alone: importing `lodestar_tpu_torch` and every one of
its modules loads neither JAX nor any module of the JAX package (nor does
importing the serving seams alone: the facade and the epoch table, nor
the observability modules alone, nor the serving stack alone, nor the
lifecycle spans and the library store alone, nor a spawned mesh worker,
nor block import's host layer alone: params, config, SSZ, types, the
state transition and `profile_block`, nor the chain alone: `BeaconChain`,
the gossip validators, fork choice and `profile_chain`, nor the
post-merge layer alone: `execution`, `eth1`, Bellatrix and Capella,
weak subjectivity and `profile_capella`), no module of it reads a
`LODESTAR_TPU_*` variable (the host layer's, the chain's and the
post-merge layer's none at all, and `LODESTAR_TPU_IMPORT_WAIT_TIMEOUT` set changes nothing)
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
                 "parallel.fleet_host") + SERVING_MODULES + HOST_LAYER_MODULES \
            + CHAIN_MODULES + EXECUTION_MODULES + NETWORK_MODULES:
        assert f"lodestar_tpu_torch.{name}" in result["modules"]


# block import's host layer: none reads any environment variable at all
HOST_LAYER_MODULES = (
    "params", "params.constants", "params.presets", "params.fork_name", "config",
    "config.chain_config", "config.fork_config", "config.beacon_config", "ssz", "ssz.hashing",
    "ssz.core", "ssz.tree_cache", "types", "types.phase0", "types.altair", "types.bellatrix",
    "types.capella", "bls.api", "state_transition", "state_transition.util",
    "state_transition.cache", "state_transition.hasher", "state_transition.block",
    "state_transition.epoch", "state_transition.altair", "state_transition.signature_sets",
    "state_transition.stf", "state_transition.genesis", "profile_block")

HOST_LAYER_PROBE = r"""
import json, sys
import lodestar_tpu_torch.params, lodestar_tpu_torch.config, lodestar_tpu_torch.ssz
import lodestar_tpu_torch.types, lodestar_tpu_torch.state_transition
import lodestar_tpu_torch.state_transition.signature_sets, lodestar_tpu_torch.profile_block
from lodestar_tpu_torch.params import ACTIVE_PRESET, MAINNET
from lodestar_tpu_torch.types import get_types
get_types(MAINNET)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps({"bad": bad, "mainnet": ACTIVE_PRESET is MAINNET}))
"""


def test_host_layer_loads_no_jax_and_reads_no_environment():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LODESTAR_TPU_PRESET"] = "minimal"  # the JAX package's knob: the port ignores it
    out = subprocess.run(
        [sys.executable, "-c", HOST_LAYER_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": [], "mainnet": True}
    for name in HOST_LAYER_MODULES:
        path = os.path.join(REPO, "lodestar_tpu_torch", *name.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\b(environ|getenv|putenv|env_str)\b", text), path


# the chain: none reads any environment variable at all
CHAIN_MODULES = (
    "fork_choice", "fork_choice.proto_array", "fork_choice.fork_choice",
    "state_transition.unrealized", "chain", "chain.chain", "chain.validation",
    "chain.clock", "chain.state_cache", "chain.seen_cache", "chain.proposer_cache",
    "chain.emitter", "chain.reprocess", "chain.op_pools", "chain.regen", "chain.archiver",
    "chain.prepare_next_slot", "db", "db.controller", "db.repository", "db.beacon",
    "light_client", "light_client.server", "profile_chain")

CHAIN_PROBE = r"""
import inspect, json, sys
import lodestar_tpu_torch.chain.chain, lodestar_tpu_torch.chain.validation
import lodestar_tpu_torch.fork_choice, lodestar_tpu_torch.profile_chain
from lodestar_tpu_torch.chain.chain import BeaconChain, _bounded_result
wait = inspect.signature(BeaconChain).parameters["import_wait_timeout_s"].default
bound = inspect.signature(_bounded_result).parameters["timeout"].default
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps({"bad": bad, "wait": wait, "bound": bound}))
"""


def test_chain_loads_no_jax_and_reads_no_environment():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LODESTAR_TPU_IMPORT_WAIT_TIMEOUT"] = "1.5"  # the JAX chain's knob: the port ignores it
    out = subprocess.run(
        [sys.executable, "-c", CHAIN_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "bad": [], "wait": 300.0, "bound": 300.0}
    for name in CHAIN_MODULES:
        path = os.path.join(REPO, "lodestar_tpu_torch", *name.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\b(environ|getenv|putenv|env_str|env_float)\b", text), path


# the post-merge layer: none reads any environment variable at all (the
# engine's, the eth1 provider's and the relay's addresses are arguments)
EXECUTION_MODULES = (
    "execution", "execution.engine", "execution.builder", "eth1", "eth1.deposit_tracker",
    "eth1.merge_tracker", "eth1.provider", "utils.http", "state_transition.bellatrix",
    "state_transition.capella", "state_transition.weak_subjectivity", "profile_capella")

EXECUTION_PROBE = r"""
import json, sys
import lodestar_tpu_torch.execution, lodestar_tpu_torch.eth1
import lodestar_tpu_torch.execution.builder, lodestar_tpu_torch.eth1.provider
import lodestar_tpu_torch.eth1.merge_tracker, lodestar_tpu_torch.profile_capella
import lodestar_tpu_torch.state_transition.weak_subjectivity
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu."))
print(json.dumps({"bad": bad}))
"""


def test_execution_and_eth1_load_no_jax_and_read_no_environment():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", EXECUTION_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": []}
    for name in EXECUTION_MODULES:
        path = os.path.join(REPO, "lodestar_tpu_torch", *name.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\b(environ|getenv|putenv|env_str|env_float)\b", text), path


# the network and its utilities: none reads any environment variable at all
# (the invalid-block directory is an argument), and none imports the
# `cryptography` wheel (the primitives are the port's own)
NETWORK_MODULES = (
    "utils.errors", "utils.queue", "network", "network.crypto", "network.transport",
    "network.peers", "network.subnets", "network.discovery", "network.network",
    "network.gossip", "network.gossip.encoding", "network.gossip.topic", "network.gossip.rpc",
    "network.gossip.score", "network.gossip.gossipsub", "network.gossip.handlers",
    "network.reqresp", "network.reqresp.snappy_frames", "network.reqresp.codec",
    "network.reqresp.protocols", "network.reqresp.handlers", "network.reqresp.service",
    "profile_network")

NETWORK_PROBE = r"""
import importlib, json, pkgutil, sys
import lodestar_tpu_torch.network as net
import lodestar_tpu_torch.utils as utils
names = []
for pkg in (net, utils):
    names.append(pkg.__name__)
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
        names.append(info.name)
import lodestar_tpu_torch.profile_network
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lodestar_tpu" or m.startswith("lodestar_tpu.")
             or m == "cryptography" or m.startswith("cryptography."))
print(json.dumps({"bad": bad, "modules": sorted(names)}))
"""


def test_network_loads_no_jax_no_cryptography_and_reads_no_environment():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LODESTAR_TPU_PERSIST_INVALID"] = "/nonexistent"  # the JAX handlers' knob: ignored
    out = subprocess.run(
        [sys.executable, "-c", NETWORK_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in NETWORK_MODULES[:-1]:
        assert f"lodestar_tpu_torch.{name}" in result["modules"], name
    for name in NETWORK_MODULES:
        path = os.path.join(REPO, "lodestar_tpu_torch", *name.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\b(environ|getenv|putenv|env_str|env_float)\b", text), path
        assert not re.search(r"^\s*(from|import) cryptography", text, re.M), path


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
