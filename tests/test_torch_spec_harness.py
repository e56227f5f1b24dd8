"""The port's spec-test harness (`spec_test/`): its generator writes the
official layout, its runners pass the valid cases, honour the
expected-invalid ones and detect a tampered vector, as in the JAX
package's harness tests. Against the JAX package: both generators write
the same files (the same decompressed SSZ, the same YAML values; the
snappy bytes may differ), each package's runners pass on the other's
tree, and the port's YAML subset agrees with PyYAML on every file either
package writes and on seeded objects read both ways, and raises on what
it does not support."""

import os
import random

import pytest
import yaml

from lodestar_tpu import native as jnative
from lodestar_tpu import spec_test as jspec
from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.spec_test.fixtures import generate_suite_tree as j_generate
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch import native
from lodestar_tpu_torch import spec_test as spec
from lodestar_tpu_torch.config.beacon_config import BeaconConfig, ChainForkConfig
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.spec_test import yaml_subset
from lodestar_tpu_torch.spec_test.fixtures import generate_suite_tree
from lodestar_tpu_torch.state_transition import interop_genesis_state
from lodestar_tpu_torch.types import get_types

N = 16


def _port_env():
    types = get_types(MINIMAL).phase0
    fork_config = ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL)
    state = interop_genesis_state(fork_config, types, N, genesis_time=1_600_000_000)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL)
    return fork_config, config, types


def _jax_env():
    from lodestar_tpu.state_transition import interop_genesis_state as j_genesis

    types = jget_types(JMINIMAL).phase0
    fork_config = JChainForkConfig(J_MINIMAL_CC, JMINIMAL)
    state = j_genesis(fork_config, types, N, genesis_time=1_600_000_000)
    config = JBeaconConfig(J_MINIMAL_CC, bytes(state.genesis_validators_root), JMINIMAL)
    return fork_config, config, types


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    fork_config, config, types = _port_env()
    jfork_config, jconfig, jtypes = _jax_env()
    root = tmp_path_factory.mktemp("port-spec-tests")
    jroot = tmp_path_factory.mktemp("jax-spec-tests")
    paths = generate_suite_tree(str(root), fork_config, types, n_validators=N)
    jpaths = j_generate(str(jroot), jfork_config, jtypes, n_validators=N)
    return {"port": (str(root), paths, config, types), "jax": (str(jroot), jpaths, jconfig, jtypes)}


@pytest.fixture
def tree(trees):
    _, paths, config, types = trees["port"]
    return paths, config, types


def test_sanity_blocks_suite_passes(tree):
    paths, config, types = tree
    result = spec.run_sanity_blocks_suite(paths["sanity/blocks"], config, types,
                                          verify_signatures=False)
    assert result.ok(), result.failures
    assert result.total == 2  # valid 2-block case + expected-invalid case


def test_sanity_slots_suite_passes(tree):
    paths, config, types = tree
    result = spec.run_sanity_slots_suite(paths["sanity/slots"], config, types)
    assert result.ok(), result.failures
    assert result.total == 2


def test_operations_suite_expected_invalid(tree):
    paths, config, types = tree
    result = spec.run_operations_suite(paths["operations/voluntary_exit"], config, types,
                                       "voluntary_exit")
    assert result.ok(), result.failures


def test_epoch_processing_suite_passes(tree):
    paths, config, types = tree
    result = spec.run_epoch_processing_suite(
        paths["epoch_processing/justification_and_finalization"], config, types,
        "justification_and_finalization")
    assert result.ok(), result.failures


def test_shuffling_suite_passes(tree):
    paths, config, types = tree
    result = spec.run_shuffling_suite(paths["shuffling"], config)
    assert result.ok(), result.failures
    assert result.total == 3


def test_tampered_vector_detected(tree):
    """Corrupting a pinned post state must fail the case."""
    paths, config, types = tree
    suite = paths["sanity/slots"]
    post_path = os.path.join(suite, "slots_1", "post.ssz_snappy")
    with open(post_path, "rb") as f:
        original = f.read()
    try:
        raw = bytearray(native.snappy_uncompress(original))
        raw[100] ^= 0xFF
        with open(post_path, "wb") as f:
            f.write(native.snappy_compress(bytes(raw)))
        result = spec.run_sanity_slots_suite(suite, config, types)
        assert not result.ok()
        assert any("slots_1" in name for name, _ in result.failures)
    finally:
        with open(post_path, "wb") as f:
            f.write(original)


def test_runner_reports_totals(tree):
    paths, config, types = tree
    result = spec.run_shuffling_suite(paths["shuffling"], config)
    assert result.total == result.passed == 3
    assert result.failures == []


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            out[os.path.relpath(os.path.join(base, name), root)] = os.path.join(base, name)
    return out


def test_both_generators_write_the_same_tree(trees):
    port, jax = _files(trees["port"][0]), _files(trees["jax"][0])
    assert sorted(port) == sorted(jax) and len(port) == 21
    for rel in port:
        with open(port[rel], "rb") as f, open(jax[rel], "rb") as g:
            mine, theirs = f.read(), g.read()
        if rel.endswith(".ssz_snappy"):
            assert native.snappy_uncompress(mine) == jnative.snappy_uncompress(theirs), rel
        else:
            assert yaml_subset.load(mine) == yaml.safe_load(theirs), rel


RUNNERS = {
    "sanity/blocks": lambda m, p, c, t: m.run_sanity_blocks_suite(p, c, t,
                                                                   verify_signatures=False),
    "sanity/slots": lambda m, p, c, t: m.run_sanity_slots_suite(p, c, t),
    "operations/voluntary_exit": lambda m, p, c, t: m.run_operations_suite(
        p, c, t, "voluntary_exit"),
    "epoch_processing/justification_and_finalization": lambda m, p, c, t:
        m.run_epoch_processing_suite(p, c, t, "justification_and_finalization"),
    "shuffling": lambda m, p, c, t: m.run_shuffling_suite(p, c),
}


@pytest.mark.parametrize("suite", sorted(RUNNERS))
def test_each_package_runs_the_other_packages_tree(trees, suite):
    _, paths, config, types = trees["port"]
    _, jpaths, jconfig, jtypes = trees["jax"]
    mine = RUNNERS[suite](spec, jpaths[suite], config, types)
    theirs = RUNNERS[suite](jspec, paths[suite], jconfig, jtypes)
    assert mine.ok() and theirs.ok(), (mine.failures, theirs.failures)
    assert (mine.total, mine.passed) == (theirs.total, theirs.passed)


def test_yaml_subset_agrees_with_pyyaml_on_every_written_file(trees):
    n = 0
    for root in (trees["port"][0], trees["jax"][0]):
        for rel, path in _files(root).items():
            if rel.endswith(".yaml"):
                with open(path, "rb") as f:
                    raw = f.read()
                assert yaml_subset.load(raw) == yaml.safe_load(raw), path
                n += 1
    assert n == 2 * 7


def _seeded(rng, depth=0):
    kind = rng.randrange(5 if depth < 3 else 3)
    if kind == 0:
        return rng.randrange(-(1 << 70), 1 << 70)
    if kind == 1:
        return "0x" + rng.randbytes(rng.randrange(0, 40)).hex()
    if kind == 2:
        return rng.choice([True, False, None, "minimal", "phase0", "a b", "it's", "-x", "#c"])
    if kind == 3:
        return [_seeded(rng, depth + 1) for _ in range(rng.randrange(4))]
    return {f"k{i}_{rng.randrange(100)}": _seeded(rng, depth + 1) for i in range(rng.randrange(4))}


def test_yaml_subset_round_trips_seeded_objects_both_ways():
    rng = random.Random(20261018)
    for _ in range(400):
        obj = _seeded(rng)
        assert yaml_subset.load(yaml.safe_dump(obj)) == obj
        assert yaml_subset.load(yaml.safe_dump(obj, default_flow_style=True)) == obj
        assert yaml.safe_load(yaml_subset.dump(obj)) == obj
        assert yaml_subset.load(yaml_subset.dump(obj)) == obj


@pytest.mark.parametrize("text", [
    "a: 1.5\n", "a: .inf\n", "a: 2001-12-14\n", "a: &x 1\nb: *x\n", "a: !!str 1\n",
    "a: |\n  x\n", "a: >\n  x\n", "a: 1\n---\nb: 2\n", "a: 1\na: 2\n", "a: b\n  c\n",
    "? a\n: b\n", "a:\n\t- 1\n", "[a: b]\n", "{a: 1}: 2\n", "a: 1:30\n",
])
def test_yaml_subset_raises_on_what_it_does_not_support(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(text)
