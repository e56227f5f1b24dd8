"""`profile_block`, the port's replay of block import, on the CPU at the
minimal preset with 64 validators: the whole scenario (`profile_block.run`:
phase0 blocks, the Altair block with its sync aggregate after the epoch
table's population, the tampered copy) through the host tier's
`CpuBlsVerifier`; then one small block through `TorchBlsVerifier(device="cpu")`: valid,
by its batch verdict, and with its two aggregates' signatures swapped, by
its per-set verdicts (the CPU batch verdict alone takes ~20 s). A valid
block's verdict is True and its post-state root the block's; the tampered
one is refused, its per-set verdicts blaming exactly the two swapped sets."""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
import torch_chain

from lodestar_tpu_torch import profile_block
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.params.presets import MINIMAL

torch.set_num_threads(1)


def test_the_scenario_through_the_host_tier():
    populated = []
    out = profile_block.run(
        CpuBlsVerifier(), validators=64, blocks=3, preset=MINIMAL, swap=(1, 3),
        populate=lambda epoch, keys: populated.append((epoch, len(keys))) or {"rows": len(keys)},
        log=lambda *a: None)
    *valid, bad = out["blocks"]
    assert [r["slot"] for r in valid] == [1, 2, 3, 9]
    # 2 committees per slot: proposer, randao, the aggregates, the sync aggregate
    assert [r["sets"] for r in valid] == [4, 4, 4, 1 + 1 + 16 + 1]
    for rec in valid:
        assert rec["verdict"] is True and all(rec["host"]) and rec["state_root_ok"]
    assert populated == [(1, 64)]
    assert bad["verdict"] is False and bad["slot"] == 9
    assert bad["swapped_sets"] == [3, 5]
    assert [k for k, ok in enumerate(bad["individual"]) if not ok] == [3, 5]
    assert [k for k, ok in enumerate(bad["host"]) if not ok] == [3, 5]
    assert bad["host_stf_error"] == "bad attestation signature"
    # the per-set verdicts' counters are recorded apart from the verdict's
    assert set(bad["individual_launches"]) == set(bad["launches"])
    assert bad["individual_supervisor"] == {} and bad["individual_probe"] == {}


def test_a_committee_signs_with_its_summed_secret_key():
    from lodestar_tpu_torch.bls.api import (
        SecretKey,
        Signature,
        aggregate_signatures,
        fast_aggregate_verify,
    )

    config, _, _ = profile_block.interop_chain(torch_chain.port_chain_config(), MINIMAL, 8)
    factory = profile_block.BlockFactory(config, 8, threads=2)
    try:
        root = bytes(range(32))
        members = [0, 3, 3, 5, 7]  # a sync committee may hold a validator twice
        (agg,) = factory.sign_aggregate([(members, root)])
        each = factory.sign([(i, root) for i in members])
        pks = [SecretKey(factory.keys[i]).to_public_key() for i in members]
    finally:
        factory.close()
    assert agg == aggregate_signatures([Signature(s) for s in each]).to_bytes()
    assert fast_aggregate_verify(pks, root, Signature(agg))


@pytest.fixture(scope="module")
def small_chain():
    return torch_chain.port_chain(plan=torch_chain.PLAN[:1])


class _PerSet:
    """The verifier's per-set verdicts as its batch verdict (their AND),
    keeping the last list: one CPU bisection answers both questions."""

    def __init__(self, verifier):
        self.verifier = verifier
        self.last = None

    def verify_signature_sets(self, sets):
        self.last = self.verifier.verify_signature_sets_individual(sets)
        return all(self.last)


def test_a_small_block_through_the_torch_verifier(small_chain):
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    chain = small_chain
    verifier = TorchBlsVerifier(device="cpu")
    signed = chain.blocks[0]
    with ThreadPoolExecutor(1) as pool:
        post, rec = profile_block.import_block(chain.genesis, signed, verifier, pool,
                                               observer=verifier.observer)
        assert rec["verdict"] is True and rec["sets"] == 4
        assert post.hash_tree_root() == bytes(signed.message.state_root)
        assert sum(rec["paths"].values()) >= 1
        pre = chain.factory.advance(chain.genesis, 1)
        bad = chain.factory.swapped(pre, signed, 0, 1)
        per_set = _PerSet(verifier)
        with pytest.raises(profile_block.BlockImportError) as err:
            profile_block.import_block(chain.genesis, bad, per_set, pool)
    assert err.value.args[1]["verdict"] is False
    assert [k for k, ok in enumerate(per_set.last) if not ok] == [2, 3]


class _DeviceDown:
    """A device tier whose every call fails."""

    def verify_signature_sets(self, sets):
        raise RuntimeError("device down")

    def verify_signature_sets_individual(self, sets):
        raise RuntimeError("device down")


def test_the_record_shows_a_verdict_the_host_tier_served(small_chain):
    """A True verdict the supervisor took from the host tier is not the
    card's: the record's supervisor counts say so, as the chip check
    reads them."""
    from lodestar_tpu_torch.chain.supervisor import SupervisedBlsVerifier
    from lodestar_tpu_torch.observability.stages import PipelineMetrics

    pm = PipelineMetrics()
    sup = SupervisedBlsVerifier(_DeviceDown(), CpuBlsVerifier(), observer=pm, retries=0,
                                canary_thread=False)
    try:
        with ThreadPoolExecutor(1) as pool:
            _, rec = profile_block.import_block(small_chain.genesis, small_chain.blocks[0], sup,
                                                pool, observer=pm, probe=lambda: {"calls": 1})
    finally:
        sup.close()
    assert rec["verdict"] is True
    assert rec["supervisor"] == {"fallback_exception": 1}
    assert rec["probe"] == {"calls": 0}
