"""`profile_network`, the port's network scenario, end to end on the CPU
at the minimal preset with 64 validators and 8 peers: through the host
tier's `CpuBlsVerifier`, through the port's `BlsLaneDispatcher` over it
flushed at the peers' cohort, through R's node's own lanes over a
supervisor of the host tier, and through a verifier that answers True to
everything, whose verdicts the run's checks catch. R is a `BeaconNode`
anchored by checkpoint sync from P's REST, range-synced by `RangeSync`;
its /metrics and REST answers are checked and its datadir resumes."""

import pytest
import torch

from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.params.presets import MINIMAL

torch.set_num_threads(1)


class _YesVerifier(CpuBlsVerifier):
    """Says True to every set: the run's checks must catch it."""

    def verify_signature_sets(self, sets, **kwargs):
        return True

    def verify_signature_sets_individual(self, sets):
        return [True] * len(list(sets))


@pytest.fixture(scope="module")
def scenario():
    from lodestar_tpu_torch import profile_block

    return profile_block.make_scenario(validators=64, blocks=3, preset=MINIMAL, swap=(1, 3),
                                       log=lambda *a: None)


@pytest.mark.parametrize("verifier", ["host", "lanes", "yes", "node_lanes", "host_cut"])
def test_profile_network_on_the_host_tier(scenario, verifier, monkeypatch):
    """`profile_network.run` end to end at the minimal preset, 8 peers, R's
    node composing its lanes over a supervisor: every check holds through
    the host tier; the lanes flush at the peers' cohort during each flood
    (restored after); they are the node's own, over the supervisor given,
    with the JAX node's defaults; and a verifier that says yes to everything
    fails the checks (the bad signatures are ACCEPTed). `host_cut` floods
    committee 0 alone (`flood_committees=1`), which still holds every
    refused, ignored and replayed message."""
    from lodestar_tpu_torch import profile_chain, profile_network
    from lodestar_tpu_torch.bls.api import SignatureSet, interop_secret_key
    from lodestar_tpu_torch.chain import dispatcher
    from lodestar_tpu_torch.chain.supervisor import SupervisedBlsVerifier

    seen = []  # (lanes, flush sets, flush wait) of every coalesced batch
    real = dispatcher.BlsLaneDispatcher._dispatch_batch

    def recorded(self, *args):
        seen.append((self, self.max_sigs, self.max_wait))
        return real(self, *args)

    monkeypatch.setattr(dispatcher.BlsLaneDispatcher, "_dispatch_batch", recorded)
    device = _YesVerifier() if verifier == "yes" else CpuBlsVerifier()
    sup = SupervisedBlsVerifier(device, CpuBlsVerifier())
    sk, msg = interop_secret_key(0), b"\x01" * 32
    # one verdict first: the supervisor's dispatch thread predates the run
    assert sup.verify_signature_sets(
        [SignatureSet(sk.to_public_key(), msg, sk.sign(msg).to_bytes())])
    chain_out = profile_chain.run(CpuBlsVerifier(), scenario=scenario, gossip_threads=8,
                                  aggregate_threads=4, flood_committees=1, keep=True,
                                  log=lambda *a: None)
    assert not chain_out["failures"] and "gossip" in chain_out
    try:
        out = profile_network.run(sup, scenario=scenario, chain_out=chain_out, peers=8,
                                  threads=16, log=lambda *a: None,
                                  flood_committees=1 if verifier == "host_cut" else None)
    finally:
        sup.close()
    lines = []
    profile_network.log_steps(out, lines.append)
    if verifier == "yes":
        assert any("attestations: unexpected" in f for f in out["failures"])
        return
    assert out["failures"] == [], out["failures"]
    assert not out["threads_left"] and out["sockets"][1] <= out["sockets"][0]
    st = out["steps"]
    assert st["range_sync"]["blocks"] == [1, 2, 3, 9]
    accepted = 4 if verifier == "host_cut" else 8  # one committee of 4, or the slot's two
    assert st["attestations"]["actions"] == {"ACCEPT": accepted, "REJECT": 3, "IGNORE": 1}
    assert st["attestations"]["replay"] == {"published_to": 1, "duplicates": 1}
    assert st["aggregates"]["actions"].get("REJECT") == 1
    assert st["block"]["gossip"] == "ACCEPT" and st["block"]["weight"][0] == st["block"]["weight"][1]
    assert out["duplicates"] == 1 and len(lines) == 6
    assert st["anchor"]["origin"] == "checkpoint" and st["close"]["origin"] == "db"
    assert st["range_sync"]["batch_states"] == {"Processed": 1}
    assert st["close"]["slot"] == st["block"]["slot"]
    moved = st["node"]["moved"]
    assert all(moved[k] > 0 for k in profile_network.NODE_MOVED + profile_network.NODE_BLS_MOVED)
    lanes = {id(lane): lane for lane, _, _ in seen}
    assert len(lanes) == 1  # R's node's lanes, and no other, coalesced the floods
    if verifier == "lanes":
        assert {(8, 1.0), (24, 1.0)} <= {(n, w) for _, n, w in seen}  # an aggregate is 3 sets
        (lane,) = lanes.values()
        assert (lane.max_sigs, lane.max_wait) == (32, 0.1)  # restored
        # the 12 validated less the wrong subnet and the second vote,
        # refused before their signatures
        assert sum(st["attestations"]["batch_sets"]) == 10
        assert st["attestations"]["failed_batch_sets"]  # the bad signatures' batches
    if verifier == "node_lanes":
        (lane,) = lanes.values()
        assert lane.verifier is sup and lane.workers == 2 and lane.max_coalesce == 512
        assert lane.pipeline is not sup.observer  # R's registry, not the supervisor's
