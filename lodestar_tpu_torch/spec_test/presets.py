"""Per-category spec-test runners over the directory layout.

Reference: `beacon-node/test/spec/presets/` — `operations.ts`,
`sanity.ts`, `epoch_processing.ts`, `shuffling.ts`: each maps a fixture
case's inputs onto one state-transition entry point and compares the
resulting state root (or expects a raise when `post` is absent).

The port's copy of the JAX package's `spec_test/presets.py`, over the
port's state transition.
"""

from __future__ import annotations

from ..state_transition import util as st_util
from ..state_transition.cache import CachedBeaconState
from .runner import SpecCase, SpecTestResult, run_directory_spec_test


def _run_case(case: SpecCase, config, state_type, mutate) -> None:
    pre = CachedBeaconState(config, state_type.deserialize(case.ssz("pre")))
    if case.has("post"):
        mutate(pre)
        pre.sync_flat()
        got = state_type.serialize(pre.state)
        assert got == case.ssz("post"), (
            f"post state mismatch (root {pre.state.hash_tree_root().hex()[:16]})"
        )
    else:
        try:
            mutate(pre)
        except Exception:
            return  # invalid input correctly rejected
        raise AssertionError("expected the transition to reject this case")


def run_operations_suite(
    suite_dir: str, config, types, operation: str, verify_signatures: bool = True
) -> SpecTestResult:
    """`operations/<operation>` — one op applied to `pre` (operations.ts)."""
    from ..state_transition import block as block_ops

    op_map = {
        "attestation": ("attestation", lambda c, op: block_ops.process_attestation(
            c, types, op, verify_signatures)),
        "attester_slashing": ("attester_slashing", lambda c, op:
            block_ops.process_attester_slashing(c, op, verify_signatures)),
        "proposer_slashing": ("proposer_slashing", lambda c, op:
            block_ops.process_proposer_slashing(c, op, verify_signatures)),
        "deposit": ("deposit", lambda c, op: block_ops.process_deposit(c, types, op)),
        "voluntary_exit": ("voluntary_exit", lambda c, op:
            block_ops.process_voluntary_exit(c, op, verify_signatures)),
        "block_header": ("block", lambda c, op:
            block_ops.process_block_header(c, types, op)),
    }
    input_stem, apply = op_map[operation]
    type_map = {
        "attestation": types.Attestation,
        "attester_slashing": types.AttesterSlashing,
        "proposer_slashing": types.ProposerSlashing,
        "deposit": types.Deposit,
        "voluntary_exit": types.SignedVoluntaryExit,
        "block": types.BeaconBlock,
    }
    op_type = type_map[input_stem]

    def test_fn(case: SpecCase) -> None:
        op = op_type.deserialize(case.ssz(input_stem))
        _run_case(case, config, types.BeaconState, lambda pre: apply(pre, op))

    return run_directory_spec_test(suite_dir, test_fn)


def run_sanity_blocks_suite(
    suite_dir: str, config, types, verify_signatures: bool = True
) -> SpecTestResult:
    """`sanity/blocks` — full state_transition over N signed blocks."""
    from ..state_transition import state_transition

    def test_fn(case: SpecCase) -> None:
        n_blocks = int(case.meta.get("blocks_count", 0))
        blocks = [
            types.SignedBeaconBlock.deserialize(case.ssz(f"blocks_{i}"))
            for i in range(n_blocks)
        ]

        def mutate(pre: CachedBeaconState) -> None:
            for signed in blocks:
                state_transition(
                    pre, types, signed,
                    verify_state_root=True,
                    verify_signatures=verify_signatures,
                )

        _run_case(case, config, types.BeaconState, mutate)

    return run_directory_spec_test(suite_dir, test_fn)


def run_sanity_slots_suite(suite_dir: str, config, types) -> SpecTestResult:
    """`sanity/slots` — process_slots by `slots.yaml` (sanity.ts)."""
    from ..state_transition import process_slots

    def test_fn(case: SpecCase) -> None:
        n_slots = int(case.files.get("slots", 0))

        def mutate(pre: CachedBeaconState) -> None:
            process_slots(pre, types, pre.state.slot + n_slots)

        _run_case(case, config, types.BeaconState, mutate)

    return run_directory_spec_test(suite_dir, test_fn)


def run_epoch_processing_suite(
    suite_dir: str, config, types, sub_transition: str
) -> SpecTestResult:
    """`epoch_processing/<sub>` — one epoch sub-transition applied at the
    epoch boundary (epoch_processing.ts)."""
    from ..state_transition import epoch as epoch_ops

    fn_map = {
        "justification_and_finalization":
            lambda c: epoch_ops.process_justification_and_finalization(c, types),
        "rewards_and_penalties": lambda c: epoch_ops.process_rewards_and_penalties(c),
        "registry_updates": lambda c: epoch_ops.process_registry_updates(c),
        "slashings": lambda c: epoch_ops.process_slashings(c),
        "effective_balance_updates":
            lambda c: epoch_ops.process_effective_balance_updates(c),
    }
    apply = fn_map[sub_transition]

    def test_fn(case: SpecCase) -> None:
        _run_case(case, config, types.BeaconState, apply)

    return run_directory_spec_test(suite_dir, test_fn)


def run_shuffling_suite(suite_dir: str, config) -> SpecTestResult:
    """`shuffling/core/shuffle` — mapping.yaml: {seed, count, mapping}
    against the swap-or-not shuffle (shuffling.ts)."""
    import numpy as np

    def test_fn(case: SpecCase) -> None:
        mapping = case.files["mapping"]
        seed = bytes.fromhex(str(mapping["seed"]).removeprefix("0x"))
        count = int(mapping["count"])
        expected = [int(x) for x in mapping["mapping"]]
        shuffled = st_util.shuffle_list(
            np.arange(count, dtype=np.uint64), seed,
            config.preset.SHUFFLE_ROUND_COUNT,
        )
        assert list(int(x) for x in shuffled) == expected, "shuffle mismatch"

    return run_directory_spec_test(suite_dir, test_fn)
