"""Spec-test fixture generator — the no-egress stand-in for downloadTests.

Reference: `spec-test-util/src/downloadTests.ts:35` fetches the official
`ethereum/consensus-spec-tests` tarballs. This environment has no
network, so this module *writes* suites in the identical directory
layout from states/blocks built by this implementation. The runner
consumes either source unchanged; official vectors are a drop-in.

Self-generated vectors cannot prove conformance against the canonical
spec by themselves — they prove serialization/layout plumbing, the
expected-invalid machinery, and regression-pin the transition: any
future change that alters a state root breaks the pinned `post` files.

The port's copy of the JAX package's `spec_test/fixtures.py`: `.yaml`
files are written by the port's `yaml_subset` (no PyYAML), `.ssz_snappy`
files compressed by the C host tier's snappy (whose bytes may differ from
the JAX package's; the decompressed SSZ is the same).
"""

from __future__ import annotations

import os

from .. import native
from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO
from ..state_transition import interop_genesis_state, process_slots, state_transition
from ..state_transition.block import _epoch_signing_root
from ..state_transition.cache import CachedBeaconState
from . import yaml_subset


def _write(case_dir: str, name: str, data) -> None:
    os.makedirs(case_dir, exist_ok=True)
    path = os.path.join(case_dir, name)
    if name.endswith(".ssz_snappy"):
        with open(path, "wb") as f:
            f.write(native.snappy_compress(data))
    else:
        with open(path, "w") as f:
            f.write(yaml_subset.dump(data))


def _sign_block(config, types, block):
    domain = config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)
    sk = bls.interop_secret_key(int(block.proposer_index))
    sig = sk.sign(compute_signing_root(block.hash_tree_root(), domain))
    return types.SignedBeaconBlock(message=block, signature=sig.to_bytes())


def _produce_block(config, types, cached: CachedBeaconState, slot: int):
    """Minimal valid block on top of `cached` (advances a copy)."""
    trial = cached.copy()
    if slot > trial.state.slot:
        process_slots(trial, types, slot)
    proposer = trial.epoch_ctx.get_beacon_proposer(slot)
    epoch = slot // config.preset.SLOTS_PER_EPOCH
    reveal = bls.interop_secret_key(proposer).sign(
        _epoch_signing_root(epoch, config.get_domain(DOMAIN_RANDAO, slot))
    ).to_bytes()
    # after process_slots the cached header's state_root is filled in by
    # process_slot, so it hashes to the true parent block root
    parent_root = trial.state.latest_block_header.hash_tree_root()
    block = types.BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=parent_root,
        state_root=b"\x00" * 32,
        body=types.BeaconBlockBody(
            randao_reveal=reveal,
            eth1_data=trial.state.eth1_data.copy(),
            graffiti=b"\x00" * 32,
        ),
    )
    post = cached.copy()
    state_transition(
        post, types, types.SignedBeaconBlock(message=block),
        verify_state_root=False, verify_signatures=False,
    )
    block.state_root = post.state.hash_tree_root()
    return _sign_block(config, types, block), post


def generate_suite_tree(root: str, config, types, n_validators: int = 16) -> dict:
    """Write a mini consensus-spec-tests tree; returns suite paths.

    Layout: <root>/minimal/phase0/<runner>/<handler>/pyspec_tests/<case>/
    — exactly the official nesting the reference walks."""
    base = os.path.join(root, "minimal", "phase0")
    genesis = interop_genesis_state(config, types, n_validators, genesis_time=1_600_000_000)
    # signing domains need the genesis validators root — promote the fork
    # config into a full BeaconConfig once genesis exists
    from ..config.beacon_config import BeaconConfig

    if not hasattr(config, "get_domain"):
        config = BeaconConfig(
            config.chain, bytes(genesis.genesis_validators_root), config.preset
        )
    state_t = types.BeaconState
    paths = {}

    # --- sanity/blocks: one valid 2-block case, one invalid (bad state root)
    suite = os.path.join(base, "sanity", "blocks", "pyspec_tests")
    cached = CachedBeaconState(config, genesis.copy())
    b1, post1 = _produce_block(config, types, cached, 1)
    b2, post2 = _produce_block(config, types, post1, 2)
    case = os.path.join(suite, "blocks_ok")
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "blocks_0.ssz_snappy", b1.serialize())
    _write(case, "blocks_1.ssz_snappy", b2.serialize())
    post2.sync_flat()
    _write(case, "post.ssz_snappy", state_t.serialize(post2.state))
    _write(case, "meta.yaml", {"blocks_count": 2})

    bad = types.SignedBeaconBlock.deserialize(b1.serialize())
    bad.message.state_root = b"\xff" * 32
    case = os.path.join(suite, "invalid_state_root")
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "blocks_0.ssz_snappy", bad.serialize())
    _write(case, "meta.yaml", {"blocks_count": 1})
    paths["sanity/blocks"] = suite

    # --- sanity/slots
    suite = os.path.join(base, "sanity", "slots", "pyspec_tests")
    case = os.path.join(suite, "slots_1")
    adv = CachedBeaconState(config, genesis.copy())
    process_slots(adv, types, 1)
    adv.sync_flat()
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "slots.yaml", 1)
    _write(case, "post.ssz_snappy", state_t.serialize(adv.state))
    case = os.path.join(suite, "over_epoch_boundary")
    spe = config.preset.SLOTS_PER_EPOCH
    adv2 = CachedBeaconState(config, genesis.copy())
    process_slots(adv2, types, spe + 1)
    adv2.sync_flat()
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "slots.yaml", spe + 1)
    _write(case, "post.ssz_snappy", state_t.serialize(adv2.state))
    paths["sanity/slots"] = suite

    # --- operations/voluntary_exit: one invalid case (validator too young)
    suite = os.path.join(base, "operations", "voluntary_exit", "pyspec_tests")
    case = os.path.join(suite, "invalid_young_validator")
    exit_msg = types.SignedVoluntaryExit(
        message=types.VoluntaryExit(epoch=0, validator_index=0),
        signature=b"\x00" * 96,
    )
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "voluntary_exit.ssz_snappy", exit_msg.serialize())
    paths["operations/voluntary_exit"] = suite

    # --- epoch_processing/justification_and_finalization (pure boundary run)
    suite = os.path.join(
        base, "epoch_processing", "justification_and_finalization", "pyspec_tests"
    )
    case = os.path.join(suite, "genesis_noop")
    jf = CachedBeaconState(config, genesis.copy())
    from ..state_transition.epoch import process_justification_and_finalization

    process_justification_and_finalization(jf, types)
    jf.sync_flat()
    _write(case, "pre.ssz_snappy", state_t.serialize(genesis))
    _write(case, "post.ssz_snappy", state_t.serialize(jf.state))
    paths["epoch_processing/justification_and_finalization"] = suite

    # --- shuffling
    import numpy as np

    from ..state_transition import util as st_util

    suite = os.path.join(base, "shuffling", "core", "shuffle")
    seed = bytes(range(32))
    for count in (1, 5, 33):
        case = os.path.join(suite, f"shuffle_{count}")
        mapping = st_util.shuffle_list(
            np.arange(count, dtype=np.uint64), seed,
            config.preset.SHUFFLE_ROUND_COUNT,
        )
        _write(
            case, "mapping.yaml",
            {
                "seed": "0x" + seed.hex(),
                "count": count,
                "mapping": [int(x) for x in mapping],
            },
        )
    paths["shuffling"] = suite

    return paths
