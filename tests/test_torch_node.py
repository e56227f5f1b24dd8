"""The port's `BeaconNode` (`node/node.py`, `init_state.py`, `notifier.py`)
against the JAX package's, on the CPU at the minimal preset with 64
validators: both nodes over the same genesis, each on a native KV
datadir with REST and metrics on loopback, driven slot by slot through
`on_clock_slot` with `tests/torch_chain.py`'s `PLAN` blocks posted
through REST `publishBlock`: equal heads and checkpoints after every
slot and equal values in the beacon metric families; `close()` persists
the head and a re-init from each datadir resumes at origin "db" with the
same state root; `init_beacon_state` anchors from a checkpoint state and
refuses one outside the weak-subjectivity period alike. Also the port's
defaults: with no verifier the node builds the serving stack on the GPU
(raises here, leaving nothing running), and `device="cpu"` builds it on
the kernels' plain versions."""

import threading
import urllib.request

import pytest
import torch
import torch_chain

from lodestar_tpu.api.client import BeaconApiClient as JClient
from lodestar_tpu.db import BeaconDb as JBeaconDb
from lodestar_tpu.db.controller import NativeKvDb as JNativeKvDb
from lodestar_tpu.node import BeaconNode as JBeaconNode
from lodestar_tpu.node import NodeOptions as JNodeOptions
from lodestar_tpu.node import init_beacon_state as j_init_beacon_state
from lodestar_tpu.node.init_state import StateInitError as JStateInitError
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.api.client import BeaconApiClient
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.db import BeaconDb
from lodestar_tpu_torch.db.controller import NativeKvDb
from lodestar_tpu_torch.node import BeaconNode, NodeOptions, init_beacon_state
from lodestar_tpu_torch.node.init_state import StateInitError
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.profile_network import prom_values
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

PT, JT = get_types(MINIMAL), jget_types(JMINIMAL)
SPE = MINIMAL.SLOTS_PER_EPOCH
# the families whose values both nodes must agree on (timings, process
# figures and the pipeline's device families are left out)
COMPARED = (
    "beacon_head_slot", "beacon_finalized_epoch", "beacon_current_justified_epoch",
    "beacon_clock_slot", "beacon_clock_epoch", "beacon_current_active_validators",
    "beacon_processed_blocks_total", "lodestar_head_slot_distance", "lodestar_sync_status",
    "lodestar_fork_choice_nodes", "lodestar_fork_choice_tracked_votes",
    "lodestar_fork_choice_proposer_boost_active", "lodestar_state_cache_size",
    "lodestar_seen_cache_size", "lodestar_op_pool_size", "lodestar_db_entries",
    "lodestar_db_live_bytes", "lodestar_db_dead_bytes",
    "lodestar_stfn_epoch_transition_seconds_count",
    "lodestar_stfn_hash_tree_root_seconds_count", "lodestar_shuffling_cache_misses_total",
    "lodestar_api_requests_total", "lodestar_block_processor_import_seconds_count",
    "lodestar_block_processor_errors_total",
)


def _scrape(node) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{node.metrics_server.port}/metrics", timeout=30) as r:
        values = prom_values(r.read().decode())
    return {k: v for k, v in values.items() if k[0] in COMPARED}


def _view(node) -> dict:
    c = node.chain
    return {"head": c.head_root, "slot": int(c.head_state.state.slot),
            "justified": c.justified_checkpoint, "finalized": c.finalized_checkpoint,
            "state_root": c.head_state.hash_tree_root()}


class Nodes:
    def __init__(self, plan, tmp_path):
        jconfig, jgen = torch_chain.jax_genesis()
        self.plan, self.jconfig, self.jgen = plan, jconfig, jgen
        self.dirs = {"port": str(tmp_path / "port-kv"), "jax": str(tmp_path / "jax-kv")}
        self.port = BeaconNode.init(plan.config, PT.phase0, plan.genesis.state.copy(), NodeOptions(
            db_controller=NativeKvDb(self.dirs["port"]), rest=True, rest_port=0, metrics=True,
            metrics_port=0, verifier=CpuBlsVerifier()))
        self.jax = JBeaconNode.init(jconfig, JT.phase0, jgen.state.copy(), JNodeOptions(
            db_controller=JNativeKvDb(self.dirs["jax"]), rest=True, rest_port=0, metrics=True,
            metrics_port=0))
        self.clients = {"port": BeaconApiClient("127.0.0.1", self.port.api_server.port),
                        "jax": JClient("127.0.0.1", self.jax.api_server.port)}

    def close(self):
        for node in (self.port, self.jax):
            node.close()


@pytest.fixture(scope="module")
def plan():
    return torch_chain.port_chain()


@pytest.fixture(scope="module")
def driven(plan, tmp_path_factory):
    """Both nodes driven over slots 1..18, the PLAN's blocks posted through
    REST; the views and scrapes after every slot."""
    nodes = Nodes(plan, tmp_path_factory.mktemp("nodes"))
    by_slot = {int(b.message.slot): b for b in plan.blocks}
    steps = []
    try:
        for slot in range(1, int(plan.blocks[-1].message.slot) + 2):
            nodes.port.on_clock_slot(slot)
            nodes.jax.on_clock_slot(slot)
            if slot in by_slot:
                signed = by_slot[slot]
                nodes.clients["port"].publishBlock(body=signed.to_obj())
                nodes.clients["jax"].publishBlock(
                    body=torch_chain.to_jax(signed, "SignedBeaconBlock").to_obj())
                nodes.port.on_clock_slot(slot)  # the gauges after the import
                nodes.jax.on_clock_slot(slot)
            steps.append((slot, _view(nodes.port), _view(nodes.jax),
                          _scrape(nodes.port), _scrape(nodes.jax)))
        head_root = nodes.port.chain.head_state.hash_tree_root()
        jhead_root = nodes.jax.chain.head_state.hash_tree_root()
    finally:
        nodes.close()
    return nodes, steps, head_root, jhead_root


def test_nodes_agree_slot_by_slot(plan, driven):
    _, steps, _, _ = driven
    for slot, pv, jv, pm, jm in steps:
        assert pv == jv, slot
        assert pm == jm, (slot, {k: (v, jm.get(k)) for k, v in pm.items() if jm.get(k) != v})
    last = steps[-1]
    assert last[1]["head"] == plan.blocks[-1].message.hash_tree_root()
    assert last[3][("beacon_processed_blocks_total", "")] == len(plan.blocks)
    assert last[3][("lodestar_stfn_epoch_transition_seconds_count", "")] > 0


def test_close_persists_and_resumes_from_the_datadir(plan, driven):
    """close() wrote the head state: each package's datadir resumes at
    origin "db" with the head's state root, read by either package."""
    nodes, _, head_root, jhead_root = driven
    assert head_root == jhead_root
    got = {}
    for name, path in nodes.dirs.items():
        for reader in ("port", "jax"):
            kv = NativeKvDb(path) if reader == "port" else JNativeKvDb(path)
            db = BeaconDb(PT.phase0, kv) if reader == "port" else JBeaconDb(JT.phase0, kv)
            init = init_beacon_state if reader == "port" else j_init_beacon_state
            types_all = PT if reader == "port" else JT
            config = plan.config if reader == "port" else nodes.jconfig
            try:
                state, origin = init(config, types_all, db)
                got[(name, reader)] = (origin, int(state.slot), state.hash_tree_root())
            finally:
                kv.close()
    assert set(got.values()) == {("db", int(plan.blocks[-1].message.slot), head_root)}


def test_checkpoint_anchor_and_weak_subjectivity_refusal(plan, tmp_path):
    """A checkpoint state anchors a node in both packages ("checkpoint",
    the state itself); past its weak-subjectivity period both refuse it
    with the same message; with nothing at all both refuse alike."""
    post = plan.posts[3]  # the Altair block's post-state, slot 9
    post.sync_flat()
    ssz = type(post.state).ssz_type.serialize(post.state)
    out = {}
    for name, init, types_all, config, err, make_db in (
            ("port", init_beacon_state, PT, plan.config, StateInitError,
             lambda: BeaconDb(PT.phase0)),
            ("jax", j_init_beacon_state, JT, torch_chain.jax_genesis()[0], JStateInitError,
             lambda: JBeaconDb(JT.phase0))):
        state, origin = init(config, types_all, make_db(), checkpoint_state_bytes=ssz,
                             checkpoint_fork="altair", current_epoch=2)
        with pytest.raises(err) as far:
            init(config, types_all, make_db(), checkpoint_state_bytes=ssz,
                 checkpoint_fork="altair", current_epoch=10**6)
        with pytest.raises(err) as none:
            init(config, types_all, make_db())
        out[name] = (origin, state.hash_tree_root(), str(far.value), str(none.value))
    assert out["port"] == out["jax"]
    assert out["port"][:2] == ("checkpoint", post.hash_tree_root())


def test_checkpoint_anchor_boots_a_node(plan):
    """The checkpoint path end to end: a node's finalized-or-head state over
    REST anchors a second node whose head is that state's."""
    node = BeaconNode.init(plan.config, PT.phase0, plan.genesis.state.copy(),
                           NodeOptions(rest=True, verifier=CpuBlsVerifier()))
    try:
        for signed in plan.blocks[:3]:
            node.on_clock_slot(int(signed.message.slot))
            node.chain.process_block(signed)
        data = BeaconApiClient("127.0.0.1", node.api_server.port).getStateV2("head")
        state, origin = init_beacon_state(plan.config, PT, BeaconDb(PT.phase0),
                                          checkpoint_state_bytes=bytes.fromhex(data["ssz"][2:]),
                                          checkpoint_fork=data["version"], current_epoch=0)
        assert origin == "checkpoint" and int(state.slot) == 3
        node2 = BeaconNode.init(plan.config, PT.phase0, state,
                                NodeOptions(rest=False, verifier=CpuBlsVerifier()))
        assert node2.chain.head_state.state.slot == 3
        from lodestar_tpu_torch.state_transition import stf

        assert stf._METRICS is node2.metrics  # the newest node's registry gets the STF timings
        node2.close()
        assert stf._METRICS is None  # and a closed node's gets none
    finally:
        node.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default on a machine without a card")
def test_default_node_needs_the_card(plan):
    """With no verifier, stack or supervisor the node builds the serving
    stack on the GPU: here, with no card, init raises and leaves no thread
    or server behind."""
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(Exception):
        BeaconNode.init(plan.config, PT.phase0, plan.genesis.state.copy(),
                        NodeOptions(rest=True, metrics=True))
    left = [t.name for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert left == []


def test_cpu_node_builds_its_stack(plan):
    """`device="cpu"`: the node's own stack on the plain versions, its
    registry the node's, the epoch table populated at an epoch start, and
    close() stopping every thread. The launch counts read 0 once the node
    is ready (past its preload), whatever came before."""
    from lodestar_tpu_torch.ops import cuda_fp
    from lodestar_tpu_torch.parallel.mesh_pool import launch_counts

    before = {t.ident for t in threading.enumerate()}
    cuda_fp.LAUNCHES += 5
    node = BeaconNode.init(plan.config, PT.phase0, plan.genesis.state.copy(),
                           NodeOptions(device="cpu", rest=False, metrics=True))
    try:
        assert set(launch_counts().values()) == {0}
        assert node.stack is not None and str(node.stack.device.device) == "cpu"
        assert node.stack.registry is node.metrics.registry
        node.on_clock_slot(SPE)
        assert node.stack.wait_populated(60)
        assert node.stack.last_populate["rows"] == 64
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{node.metrics_server.port}/metrics", timeout=30).read().decode()
        assert 'backend="cpu"' in text and "lodestar_bls_epoch_table_occupancy" in text
    finally:
        node.close()
    left = [t.name for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert left == []
