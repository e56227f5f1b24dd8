"""The port's beacon metric set (`metrics/beacon.py`, `gc_stats.py`,
`validator_monitor.py`) against the JAX package's: every family's name,
type, help, labels and buckets equal (the build-info gauge's first two
labels carry the port's runtime, as `observability/stages.py` says); the
exposition text lists the same families; the facades' families of
`metrics/bls.py` are the beacon set's own, not declared twice; the STF
hook (`state_transition.stf.set_metrics`) moves the same families by the
same counts in both packages on an epoch transition; the validator
monitor counts the same duties."""

import gc

import pytest
import torch

from lodestar_tpu.metrics.beacon import create_beacon_metrics as j_create
from lodestar_tpu.metrics.gc_stats import GcMetrics as JGcMetrics
from lodestar_tpu.metrics.registry import MetricsRegistry as JRegistry
from lodestar_tpu.metrics.validator_monitor import ValidatorMonitor as JMonitor
from lodestar_tpu_torch.metrics.beacon import create_beacon_metrics
from lodestar_tpu_torch.metrics.bls import create_bls_metrics
from lodestar_tpu_torch.metrics.gc_stats import GcMetrics, install_gc_metrics
from lodestar_tpu_torch.metrics.registry import MetricsRegistry
from lodestar_tpu_torch.metrics.validator_monitor import ValidatorMonitor

torch.set_num_threads(1)

BUILD_INFO = "lodestar_tpu_build_info"


def _families(registry) -> dict:
    return {m.name: (m.kind, m.help, tuple(m.label_names), tuple(getattr(m, "buckets", ())))
            for m in registry._metrics}


def test_beacon_families_equal_jax():
    port, jax = _families(create_beacon_metrics().registry), _families(j_create().registry)
    assert set(port) == set(jax)
    for name in port:
        if name == BUILD_INFO:
            assert port[name][0] == jax[name][0]
            assert port[name][2][2:] == jax[name][2][2:]  # torch, CUDA in place of jax, jaxlib
        else:
            assert port[name] == jax[name], name
    assert len(port) > 150


def test_exposition_lists_the_same_families():
    def heads(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith(("# TYPE", "# HELP")) and BUILD_INFO not in line)

    assert heads(create_beacon_metrics().registry.expose()) == \
        heads(j_create().registry.expose())


def test_bls_families_declared_once():
    """The facades' seven families are the beacon set's own attributes, and
    a stack's `create_bls_metrics` over the node's registry reuses them."""
    m = create_beacon_metrics()
    n = len(m.registry._metrics)
    bls = create_bls_metrics(m.registry)
    assert len(m.registry._metrics) == n
    for attr in ("bls_batches_total", "bls_sets_total", "bls_batch_fallbacks_total",
                 "bls_buffer_depth", "bls_buffer_wait_seconds", "bls_job_sets",
                 "bls_main_thread_sets_total"):
        assert getattr(bls, attr) is getattr(m, attr)
    names = [x.name for x in m.registry._metrics]
    assert len(names) == len(set(names))


def test_gc_and_monitor_families_equal_jax():
    port, jax = MetricsRegistry(), JRegistry()
    GcMetrics(port)
    JGcMetrics(jax)
    ValidatorMonitor(port)
    JMonitor(jax)
    assert _families(port) == _families(jax)


def test_gc_metrics_rebind_to_a_new_registry():
    first = MetricsRegistry()
    install_gc_metrics(first)
    gc.collect()
    second = MetricsRegistry()
    g = install_gc_metrics(second)
    before = sum(g.collections_total._values.values())
    gc.collect()
    assert sum(g.collections_total._values.values()) > before
    assert g.pause_seconds in second._metrics


def _counts(m) -> dict:
    out = {}
    for attr in ("epoch_transition_seconds", "state_hash_seconds", "state_hash_dirty_validators"):
        out[attr] = sum(getattr(m, attr)._totals.values())
    for attr in ("shuffling_cache_hits_total", "shuffling_cache_misses_total"):
        out[attr] = sum(getattr(m, attr)._values.values())
    return out


def test_stf_families_move_alike_on_an_epoch_transition():
    """The STF hook in both packages: processing a genesis across an epoch
    boundary and reading committees moves the same families by the same
    counts."""
    import torch_chain

    from lodestar_tpu.state_transition import stf as jstf
    from lodestar_tpu.state_transition.stf import process_slots as j_process_slots
    from lodestar_tpu_torch import profile_block
    from lodestar_tpu_torch.params.presets import MINIMAL
    from lodestar_tpu_torch.state_transition import stf
    from lodestar_tpu_torch.state_transition.stf import fork_types, process_slots

    config, genesis, _ = profile_block.interop_chain(torch_chain.port_chain_config(),
                                                     MINIMAL, 16)
    _, jgen = torch_chain.jax_genesis(16)
    pm, jm = create_beacon_metrics(), j_create()
    stf.set_metrics(pm)
    jstf.set_metrics(jm)
    try:
        p, j = genesis.copy(), jgen.copy()
        process_slots(p, fork_types(p), 2 * MINIMAL.SLOTS_PER_EPOCH + 1)
        j_process_slots(j, jstf.fork_types(j), 2 * MINIMAL.SLOTS_PER_EPOCH + 1)
        for slot in range(2 * MINIMAL.SLOTS_PER_EPOCH, 2 * MINIMAL.SLOTS_PER_EPOCH + 3):
            p.epoch_ctx.get_beacon_committee(slot, 0)
            j.epoch_ctx.get_beacon_committee(slot, 0)
        assert p.hash_tree_root() == j.hash_tree_root()
    finally:
        stf.set_metrics(None)
        jstf.set_metrics(None)
    got, want = _counts(pm), _counts(jm)
    assert got == want
    assert got["epoch_transition_seconds"] == 2 and got["shuffling_cache_hits_total"] >= 3
    assert got["state_hash_seconds"] == 2 * MINIMAL.SLOTS_PER_EPOCH + 1


@pytest.mark.parametrize("monitored", [(), (0, 3)])
def test_validator_monitor_matches_jax(monitored):
    """The same duty events through both monitors: equal summaries and
    equal counter values."""
    port_reg, jax_reg = MetricsRegistry(), JRegistry()
    mons = (ValidatorMonitor(port_reg), JMonitor(jax_reg))
    for mon in mons:
        for i in monitored:
            mon.register_validator(i)
        mon.on_gossip_attestation(1, 0, 1.5)
        mon.on_attestation_included(1, [0, 3, 5], 2, True, False)
        mon.on_attestation_included(1, [0], 1, True, True)
        mon.on_aggregate_published(1, 3)
        mon.on_block_proposed(1, 0, 0.7)
        mon.on_sync_committee_message(1, 3)
        mon.on_sync_signature_included(1, [3, 5])
        mon.on_balances(1, [32_000_000_000 + i for i in range(8)])
    sums = [{k: vars(v) for k, v in m.summarize_epoch(1).items()} for m in mons]
    assert sums[0] == sums[1]
    assert port_reg.expose() == jax_reg.expose()
