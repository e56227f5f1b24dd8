"""`profile_chain`, the port's one-slot chain scenario, end to end on the
CPU at the minimal preset with 64 validators: through the host tier's
`CpuBlsVerifier`, through the port's `BlsLaneDispatcher` over it (the
coalesced batches and lanes recorded), and through a verifier that
answers True to everything, whose verdicts the run's checks catch."""

import pytest
import torch

from lodestar_tpu_torch import profile_block, profile_chain
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.dispatcher import BlsLaneDispatcher
from lodestar_tpu_torch.params.presets import MINIMAL

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenario():
    return profile_block.make_scenario(validators=64, blocks=3, preset=MINIMAL, swap=(1, 3),
                                       log=lambda *a: None)


def _run(verifier, scenario):
    lines = []
    out = profile_chain.run(verifier, scenario=scenario, gossip_threads=8,
                            aggregate_threads=4, log=lines.append)
    profile_chain.log_steps(out, lines.append)
    return out, lines


def test_the_slot_through_the_host_tier(scenario):
    out, lines = _run(CpuBlsVerifier(), scenario)
    assert out["failures"] == []
    s = out["steps"]
    assert s["segment"]["sets"] == 12 and s["segment"]["verdicts"] == 1
    assert s["tampered"]["refused"] == "block signature set verification failed"
    assert s["altair"]["gossip"] == ["ACCEPT", ""]
    # 2 committees of 4: 8 single-bit attestations and the four extra messages
    att = s["attestations"]
    assert att["calls"] == 12 and att["members"] == 8
    assert att["actions"] == {"ACCEPT": 8, "REJECT": 3, "IGNORE": 1}
    # every member is an aggregator at the minimal committee size
    agg = s["aggregates"]
    assert agg["aggregators"] == 8 and agg["actions"] == {"ACCEPT": 8, "REJECT": 1}
    assert agg["weight"] == agg["votes"] + agg["boost"] and agg["boost"] > 0
    prod = s["produce"]
    assert prod["carried"] == [0, 1] and prod["carried_bits"] == [3, 3]
    assert out["head"] and len(lines) == 6


def test_the_slot_through_the_lane_dispatcher(scenario):
    lanes = BlsLaneDispatcher(CpuBlsVerifier())
    try:
        out, _ = _run(lanes, scenario)
    finally:
        lanes.close()
    assert out["failures"] == []
    att, agg = out["steps"]["attestations"], out["steps"]["aggregates"]
    assert att["lanes"] == ["attestation"] and agg["lanes"] == ["aggregate"]
    assert att["batches"] >= 1 and sum(att["batch_sizes"]) >= 10
    assert agg["batches"] >= 1 and sum(agg["batch_sizes"]) >= 27


class _SaysYes:
    def verify_signature_sets(self, sets):
        return True

    def verify_signature_sets_individual(self, sets):
        return [True] * len(list(sets))


def test_a_verifier_that_says_yes_fails_the_checks(scenario):
    out, _ = _run(_SaysYes(), scenario)
    text = " ".join(out["failures"])
    assert "tampered: the block was imported" in text
    assert "verdicts differ from the host tier's" in text
    assert "attestations: unexpected" in text
