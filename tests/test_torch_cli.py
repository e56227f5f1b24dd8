"""The port's CLI, `python -m lodestar_tpu_torch.cli beacon`, on the CPU
(`--device cpu`: the node's stack on the kernels' plain versions): a
subprocess on an interop genesis of 16 validators answers
`/eth/v1/node/health` and `/metrics` (no native-KV fallback, the build
info's backend `cpu`), exits 0 at `--run-seconds`, writes `kv/`, and a
second run resumes from it (origin "db"); SIGINT ends it with 0 too. A
`network_key` written by the JAX CLI's `_load_identity` gives the same
peer id in the port, and the reverse."""

import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(datadir, run_seconds, rest_port=None, metrics_port=None, validators=16):
    cmd = [sys.executable, "-m", "lodestar_tpu_torch.cli", "beacon", "--device", "cpu",
           "--network", "minimal-dev", "--genesis-validators", str(validators),
           "--datadir", datadir, "--run-seconds", str(run_seconds)]
    if rest_port is not None:
        cmd += ["--rest", "--rest-port", str(rest_port)]
    if metrics_port is not None:
        cmd += ["--metrics", "--metrics-port", str(metrics_port)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _get(port, path, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                return r.status, r.read().decode()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def test_beacon_runs_serves_and_resumes(tmp_path):
    datadir = str(tmp_path / "node")
    rest, metrics = _free_port(), _free_port()
    proc = _start(datadir, 8, rest, metrics)
    try:
        status, body = _get(rest, "/eth/v1/node/health")
        assert status == 200 and body == "{}"
        _, text = _get(metrics, "/metrics")
        assert re.search(r"^lodestar_db_native_kv_fallbacks_total 0", text, re.M)
        assert 'backend="cpu"' in text
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "anchor: genesis" in out and "node stopped; state persisted" in out
    assert os.path.isdir(os.path.join(datadir, "kv"))
    assert not os.path.exists(os.path.join(datadir, "chain.db"))

    proc = _start(datadir, 1)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert "anchor: db (slot 0)" in out


def test_sigint_exits_zero(tmp_path):
    rest = _free_port()
    proc = _start(str(tmp_path / "node"), 60, rest)
    try:
        _get(rest, "/eth/v1/node/health")
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "node stopped; state persisted" in out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_network_key_gives_the_same_peer_id(tmp_path, writer):
    """The datadir's 32-byte `network_key` is the Ed25519 private key in
    both CLIs: the peer id is the same whichever package wrote it."""
    pytest.importorskip("cryptography")  # the JAX CLI's Ed25519
    from lodestar_tpu.cli.beacon import _load_identity as j_load_identity
    from lodestar_tpu_torch.cli.beacon import _load_identity

    datadir = str(tmp_path)
    first, second = (j_load_identity, _load_identity) if writer == "jax" else \
        (_load_identity, j_load_identity)
    a = first(datadir)
    assert os.path.getsize(os.path.join(datadir, "network_key")) == 32
    b = second(datadir)
    assert a.peer_id == b.peer_id
    assert _load_identity(datadir).peer_id == a.peer_id  # and again from the file


def test_identity_of_a_datadir(tmp_path):
    """Without the JAX side: the key is written once, 0600, and reused."""
    from lodestar_tpu_torch.cli.beacon import _load_identity

    a = _load_identity(str(tmp_path))
    path = os.path.join(str(tmp_path), "network_key")
    assert oct(os.stat(path).st_mode & 0o777) == "0o600"
    assert _load_identity(str(tmp_path)).peer_id == a.peer_id
    assert _load_identity(None) is None


def test_validator_proposes_and_attests(tmp_path):
    """`validator` as a subprocess against an in-process port node (REST
    on loopback, the host tier's verifier, its clock following the wall
    clock): it proposes the block of the slot it starts in and attests,
    then exits 0 at `--run-seconds`; its slashing-protection `FileDb`
    holds both."""
    import threading

    from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
    from lodestar_tpu_torch.config.beacon_config import BeaconConfig, ChainForkConfig
    from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
    from lodestar_tpu_torch.db.controller import FileDb
    from lodestar_tpu_torch.node import BeaconNode, NodeOptions
    from lodestar_tpu_torch.params.presets import MINIMAL
    from lodestar_tpu_torch.state_transition import interop_genesis_state
    from lodestar_tpu_torch.types import get_types
    from lodestar_tpu_torch.validator import SlashingProtection

    n, spt = 16, MINIMAL_CHAIN_CONFIG.SECONDS_PER_SLOT
    genesis_time = int(time.time()) - spt  # slot 1 for the next 6 s
    types = get_types(MINIMAL).phase0
    state = interop_genesis_state(ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL), types, n,
                                  genesis_time=genesis_time)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL)
    node = BeaconNode.init(config, types, state,
                           NodeOptions(rest=True, rest_port=0, verifier=CpuBlsVerifier()))
    stop = threading.Event()

    def follow_wall_clock():
        while not stop.is_set():
            node.on_clock_slot(max(0, int(time.time() - genesis_time) // spt))
            stop.wait(0.1)

    clock = threading.Thread(target=follow_wall_clock, daemon=True)
    clock.start()
    vc_db = str(tmp_path / "vc.db")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "lodestar_tpu_torch.cli", "validator", "--network",
             "minimal-dev", "--beacon-url", f"http://127.0.0.1:{node.api_server.port}",
             "--interop-keys", f"0:{n}", "--datadir", vc_db, "--run-seconds", "3"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        head_slot = int(node.chain.head_state.state.slot)
        head_block = node.chain.blocks[node.chain.head_root].message
    finally:
        stop.set()
        clock.join()
        node.close()
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "16 validator keys loaded" in out
    assert f"proposed block at slot {head_slot}" in out, out
    assert head_slot >= 1
    pks = [bytes(state.validators[i].pubkey) for i in range(n)]
    interchange = SlashingProtection(FileDb(vc_db)).export_interchange(
        bytes(state.genesis_validators_root), pks)
    proposer = interchange["data"][int(head_block.proposer_index)]["signed_blocks"]
    assert head_slot in [int(b["slot"]) for b in proposer]
    attesters = [e for e in interchange["data"] if e["signed_attestations"]]
    assert len(attesters) >= 2  # a slot's committee: 16 validators / 8 slots
    assert all(a["target_epoch"] == "0" for e in attesters for a in e["signed_attestations"])


@pytest.mark.slow
def test_dev_on_the_cpu_stack():
    """`dev --device cpu`: one slot's block through the serving stack on
    the kernels' plain versions (minutes on a CPU, past the supervisor's
    120 s deadline, so the host tier answers), then exit 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "lodestar_tpu_torch.cli", "dev", "--device", "cpu",
         "--validators", "16", "--slots", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "done: head slot 1" in out
