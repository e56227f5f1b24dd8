"""`profile_network`, the port's network scenario, end to end on the CPU
at the minimal preset with 64 validators and 8 peers: through the host
tier's `CpuBlsVerifier`, through the port's `BlsLaneDispatcher` over it
flushed at the peers' cohort, and through a verifier that answers True to
everything, whose verdicts the run's checks catch."""

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


@pytest.mark.parametrize("verifier", ["host", "lanes", "yes"])
def test_profile_network_on_the_host_tier(scenario, verifier):
    """`profile_network.run` end to end at the minimal preset, 8 peers:
    every check holds through the host tier, alone and behind a lane
    dispatcher flushed at the peers' cohort (restored after), and a
    verifier that says yes to everything fails the checks (the bad
    signatures are ACCEPTed)."""
    from lodestar_tpu_torch import profile_chain, profile_network
    from lodestar_tpu_torch.chain.dispatcher import BlsLaneDispatcher

    class Lanes(BlsLaneDispatcher):
        """Records the flush each batch saw."""

        flushes: list = []

        def _dispatch_batch(self, *args):
            self.flushes.append((self.max_sigs, self.max_wait))
            return super()._dispatch_batch(*args)

    v = {"host": CpuBlsVerifier, "yes": _YesVerifier,
         "lanes": lambda: Lanes(CpuBlsVerifier(), workers=1, max_sigs=64)}[verifier]()
    chain_out = profile_chain.run(CpuBlsVerifier(), scenario=scenario, gossip_threads=8,
                                  aggregate_threads=4, flood_committees=1, keep=True,
                                  log=lambda *a: None)
    assert not chain_out["failures"] and "gossip" in chain_out
    seen = v.flushes if verifier == "lanes" else []
    try:
        out = profile_network.run(v, scenario=scenario, chain_out=chain_out, peers=8,
                                  threads=16, log=lambda *a: None)
    finally:
        if verifier == "lanes":
            assert (v.max_sigs, v.max_wait) == (64, 0.1)  # restored
            v.close()
    lines = []
    profile_network.log_steps(out, lines.append)
    if verifier == "yes":
        assert any("attestations: unexpected" in f for f in out["failures"])
        return
    assert out["failures"] == [], out["failures"]
    assert not out["threads_left"] and out["sockets"][1] <= out["sockets"][0]
    st = out["steps"]
    assert st["range_sync"]["blocks"] == [1, 2, 3, 9]
    assert st["attestations"]["actions"] == {"ACCEPT": 8, "REJECT": 3, "IGNORE": 1}
    assert st["attestations"]["replay"] == {"published_to": 1, "duplicates": 1}
    assert st["aggregates"]["actions"].get("REJECT") == 1
    assert st["block"]["gossip"] == "ACCEPT" and st["block"]["weight"][0] == st["block"]["weight"][1]
    assert out["duplicates"] == 1 and len(lines) == 5
    if verifier == "lanes":
        assert {(8, 1.0), (24, 1.0)} <= set(seen)  # 8 peers; an aggregate is three sets
        # the 12 validated less the wrong subnet and the second vote,
        # refused before their signatures
        assert sum(st["attestations"]["batch_sets"]) == 10
        assert st["attestations"]["failed_batch_sets"]  # the bad signatures' batches
