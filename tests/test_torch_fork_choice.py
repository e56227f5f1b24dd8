"""The port's fork choice (`lodestar_tpu_torch/fork_choice`) against the
JAX package's, exactly: seeded numpy scripts of blocks, votes, slot
ticks, proposer boosts, balance changes, equivocations and prunes over
trees of 64–256 blocks and 64 voters run through both `ForkChoice`s,
with the head and every node's weight, best child and best descendant
equal after each head update; every scenario of `tests/test_fork_choice.py`
on both packages; and a script carried halfway from JAX to the port with
`convert.fork_choice_from_jax`."""

import numpy as np
import pytest
import test_fork_choice as jax_scenarios

import lodestar_tpu.fork_choice as jfc_mod
import lodestar_tpu_torch.fork_choice as pfc_mod
from lodestar_tpu_torch.convert import fork_choice_from_jax

VOTERS = 64
SPE = 8
SCENARIOS = sorted(n for n in dir(jax_scenarios) if n.startswith("test_"))


def _root(i: int) -> bytes:
    return i.to_bytes(32, "big")


def make_fc(mod, balances):
    proto = mod.ProtoArray(justified_epoch=0, finalized_epoch=0)
    proto.on_block(0, _root(0), None, b"\x00" * 32, 0, 0)
    proto.prune_threshold = 8
    store = mod.ForkChoiceStore(
        current_slot=0, justified_checkpoint=(0, _root(0)),
        finalized_checkpoint=(0, _root(0)), justified_balances=balances.copy())
    return mod.ForkChoice(store, proto, slots_per_epoch=SPE)


def view(fc) -> dict:
    """Everything the head update decides, in comparable form."""
    p = fc.proto
    return {
        "head": fc.head_root,
        "roots": [n.root for n in p.nodes],
        "weights": [int(w) for w in p.weights],
        "best_child": [n.best_child for n in p.nodes],
        "best_descendant": [n.best_descendant for n in p.nodes],
        "boost": fc.proposer_boost_root,
        "store": (fc.store.current_slot, fc.store.justified_checkpoint,
                  fc.store.finalized_checkpoint),
    }


def script(seed: int, n_blocks: int) -> list:
    """A seeded list of operations over a tree of `n_blocks` blocks: the
    same list drives both packages. Parents are drawn from the nodes that
    survive the last prune, which finalizes an ancestor of the newest
    block."""
    rng = np.random.default_rng(seed)
    ops, slot_of, parent_of = [], {0: 0}, {0: None}
    alive, now, made = [0], 0, 0

    def descendants(root):
        out = {root}
        for r in sorted(parent_of):
            if parent_of[r] in out:
                out.add(r)
        return out

    while made < n_blocks:
        kind = rng.choice(["block", "block", "block", "att", "att", "time", "head",
                           "slash", "balances", "prune"],
                          p=[0.2, 0.15, 0.1, 0.2, 0.1, 0.08, 0.1, 0.02, 0.03, 0.02])
        if kind == "block":
            made += 1
            parent = int(rng.choice(alive))
            slot = max(now, slot_of[parent] + 1)
            if slot > now and rng.random() < 0.5:
                slot = slot_of[parent] + int(rng.integers(1, 3))
            now = max(now, slot)
            delay = [None, 0.5, 2.0, 5.0][int(rng.integers(0, 4))]
            slot_of[made], parent_of[made] = slot, parent
            alive.append(made)
            ops.append(("block", slot, made, parent, delay))
        elif kind == "att":
            k = int(rng.integers(1, 16))
            voters = sorted(int(v) for v in rng.choice(VOTERS, k, replace=False))
            target = int(rng.choice(alive))
            epoch = now // SPE + (1 if rng.random() < 0.1 else 0)
            ops.append(("att", voters, target, epoch))
        elif kind == "time":
            now += int(rng.integers(1, 4))
            ops.append(("time", now))
        elif kind == "head":
            ops.append(("head",))
        elif kind == "slash":
            ops.append(("slash", [int(v) for v in rng.choice(VOTERS, 2, replace=False)]))
        elif kind == "balances":
            ops.append(("balances", rng.integers(16, 33, VOTERS).astype(np.int64) * 10**9))
        elif kind == "prune" and made > 8:
            # finalize the highest of the newest block's few nearest
            # ancestors whose descendants are every block made after it
            # (the proto-array prunes by insertion index)
            path, node = [], made
            for _ in range(int(rng.integers(1, 5))):
                if node is None or node not in alive:
                    break
                path.append(node)
                node = parent_of[node]
            fit = [c for c in path if all(r in descendants(c) for r in parent_of if r > c)]
            if fit and fit[-1] != alive[0]:
                keep = descendants(fit[-1])
                alive = [r for r in alive if r in keep]
                ops.append(("prune", fit[-1]))
        if kind in ("block", "prune"):
            ops.append(("head",))
    ops.append(("head",))
    return ops


def apply(fc, op) -> None:
    kind = op[0]
    if kind == "block":
        _, slot, me, parent, delay = op
        if slot > fc.store.current_slot:
            fc.update_time(slot)
        j, f = fc.store.justified_checkpoint, fc.store.finalized_checkpoint
        fc.on_block(slot, _root(me), _root(parent), b"", j, f, block_delay_sec=delay)
    elif kind == "att":
        fc.on_attestation(op[1], _root(op[2]), op[3])
    elif kind == "time":
        fc.update_time(op[1])
    elif kind == "head":
        fc.update_head()
    elif kind == "slash":
        fc.on_attester_slashing(op[1])
    elif kind == "balances":
        fc.store.justified_balances = op[1].copy()
    elif kind == "prune":
        fc.store.justified_checkpoint = fc.store.finalized_checkpoint = (0, _root(op[1]))
        fc.prune()


def _balances(seed):
    return np.random.default_rng(seed + 1000).integers(16, 33, VOTERS).astype(np.int64) * 10**9


@pytest.mark.parametrize("seed,n_blocks", [(1, 64), (2, 128), (3, 256)])
def test_seeded_script_matches_jax(seed, n_blocks):
    ops = script(seed, n_blocks)
    jax_fc, port_fc = make_fc(jfc_mod, _balances(seed)), make_fc(pfc_mod, _balances(seed))
    heads, prunes = 0, 0
    for op in ops:
        apply(jax_fc, op)
        apply(port_fc, op)
        if op[0] == "head":
            heads += 1
            assert view(port_fc) == view(jax_fc), f"after head update {heads}"
        prunes += op[0] == "prune"
    assert heads > n_blocks and prunes >= 1
    assert len(set(view(port_fc)["weights"])) > 2  # the votes moved weight around


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fork_choice_scenario(scenario, package, monkeypatch):
    if package == "port":
        for name in ("ForkChoice", "ForkChoiceStore", "ProtoArray"):
            monkeypatch.setattr(jax_scenarios, name, getattr(pfc_mod, name))
    getattr(jax_scenarios, scenario)()


def test_carried_over_from_jax_finishes_equal():
    ops = script(7, 128)
    half = len(ops) // 2
    jax_fc = make_fc(jfc_mod, _balances(7))
    for op in ops[:half]:
        apply(jax_fc, op)
    port_fc = fork_choice_from_jax(jax_fc)
    assert isinstance(port_fc, pfc_mod.ForkChoice)
    assert view(port_fc) == view(jax_fc)
    assert port_fc._vote_next == jax_fc._vote_next and port_fc._equivocating == jax_fc._equivocating
    for op in ops[half:]:
        apply(jax_fc, op)
        apply(port_fc, op)
        if op[0] == "head":
            assert view(port_fc) == view(jax_fc)
