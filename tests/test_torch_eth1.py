"""The port's `eth1/` (deposit tracker, eth1-data vote, merge tracker,
JSON-RPC provider) and `DepositTree.proof` against the JAX package's, on
the minimal preset: proofs byte for byte at several leaf counts; the
deposits a tracker serves, carried by a produced block through both
packages' state transition to equal state roots; the vote; the terminal
PoW block; and the provider's requests and decoded logs against a
recording JSON-RPC server on 127.0.0.1 (`torch_loopback.py`). Data made
from a numpy seed. Tolerance: bytes equal."""

import dataclasses

import numpy as np
import pytest
import torch_capella as tc
import torch_loopback

from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.eth1 import deposit_tracker as jdt
from lodestar_tpu.eth1 import merge_tracker as jmt
from lodestar_tpu.eth1 import provider as jprovider
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition.genesis import DepositTree as JDepositTree
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.config.beacon_config import ChainForkConfig
from lodestar_tpu_torch.eth1 import deposit_tracker as dt
from lodestar_tpu_torch.eth1 import merge_tracker as mt
from lodestar_tpu_torch.eth1 import provider
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition.genesis import DepositTree, make_interop_deposits
from lodestar_tpu_torch.state_transition.util import is_valid_merkle_branch
from lodestar_tpu_torch.types import get_types

SEED = 18
T = get_types(MINIMAL).phase0
JT = jget_types(JMINIMAL).phase0


@pytest.mark.parametrize("count", [1, 2, 3, 5, 16, 33, 70])
def test_deposit_tree_proofs_are_the_jax_ones(count):
    rng = np.random.default_rng(SEED + count)
    ours, theirs = DepositTree(), JDepositTree()
    for _ in range(count):
        leaf = rng.bytes(32)
        ours.append(leaf)
        theirs.append(leaf)
    assert ours.root() == theirs.root()
    for i in sorted({0, count // 2, count - 1, *rng.integers(0, count, 4).tolist()}):
        proof = ours.proof(i)
        assert proof == theirs.proof(i)
        assert is_valid_merkle_branch(ours.leaves[i], proof, ours.depth + 1, i, ours.root())
    assert ours.last_proof() == ours.proof(count - 1)
    with pytest.raises(IndexError):
        ours.proof(count)


@pytest.fixture(scope="module")
def deposits():
    """The interop deposits of validators 0..17 (the genesis holds 16) in
    both packages' types."""
    config = ChainForkConfig(tc.MINIMAL_CHAIN_CONFIG.with_overrides(**tc.SCHEDULE), MINIMAL)
    ours = make_interop_deposits(config, T, tc.N + 2)
    return [d.data for d in ours], [JT.DepositData.deserialize(d.data.serialize()) for d in ours]


def _trackers(datas, jdatas):
    """Both packages' trackers following a mock eth1 chain of two blocks:
    the genesis deposits, then two more."""
    out = []
    configs = (ChainForkConfig(tc.MINIMAL_CHAIN_CONFIG, MINIMAL),
               JChainForkConfig(tc.J_MINIMAL_CC, JMINIMAL))
    for mod, ds, types, config in zip((dt, jdt), (datas, jdatas), (T, JT), configs):
        chain = mod.Eth1ProviderMock()
        chain.add_block(b"\x11" * 32, 100, ds[:tc.N])
        chain.add_block(b"\x22" * 32, 200, ds[tc.N:])
        tracker = mod.Eth1DepositTracker(config, types, chain)
        tracker.follow()
        out.append(tracker)
    return out


def test_deposit_inclusion_through_a_produced_block(deposits):
    datas, jdatas = deposits
    config, state, jconfig, jstate = tc.altair_pair()
    tracker, jtracker = _trackers(datas, jdatas)
    assert tracker.tree.root() == jtracker.tree.root()
    # the genesis deposit root is the tracker's after its first block
    assert bytes(state.eth1_data.deposit_root) == tracker.provider.blocks[0].deposit_root
    vote = tracker.get_eth1_vote(state, 0)
    assert vote.serialize() == jtracker.get_eth1_vote(jstate, 0).serialize()
    assert vote.deposit_count == tc.N + 2
    # the eth1 data adopted (as a vote majority would): two deposits due
    state.eth1_data, jstate.eth1_data = vote.copy(), jtracker.get_eth1_vote(jstate, 0)
    included = tracker.get_deposits_for_block(state)
    assert [d.serialize() for d in included] == [
        d.serialize() for d in jtracker.get_deposits_for_block(jstate)]
    assert len(included) == 2
    cached = tc.port_cached(config, state)
    jcached = tc.JCached(jconfig, jstate, JMINIMAL)
    block_types = get_types(MINIMAL).altair
    signed = tc.produce_block(config, cached, 1, deposits=[
        block_types.Deposit.deserialize(d.serialize()) for d in included])
    from lodestar_tpu.state_transition import state_transition as j_state_transition

    from lodestar_tpu_torch.state_transition import state_transition

    state_transition(cached, block_types, signed)
    j_state_transition(jcached, jget_types(JMINIMAL).altair, tc.to_jax(signed),
                       verify_signatures=False)
    assert cached.hash_tree_root() == jcached.hash_tree_root()
    assert len(cached.state.validators) == tc.N + 2 and cached.state.eth1_deposit_index == tc.N + 2


def test_the_eth1_vote(deposits):
    datas, jdatas = deposits
    _, state, _, jstate = tc.altair_pair()
    tracker, jtracker = _trackers(datas, jdatas)
    rng = np.random.default_rng(SEED)
    candidates = [T.Eth1Data(deposit_root=rng.bytes(32), deposit_count=tc.N + k,
                             block_hash=rng.bytes(32)) for k in range(3)]
    for votes in ([0, 0, 1], [0, 1], [2, 2, 2, 1], [], [1, 0, 2]):
        state.eth1_data_votes = [candidates[k].copy() for k in votes]
        jstate.eth1_data_votes = [JT.Eth1Data.deserialize(candidates[k].serialize())
                                  for k in votes]
        assert tracker.get_eth1_vote(state, 0).serialize() == jtracker.get_eth1_vote(
            jstate, 0).serialize(), votes
    # the eth1 chain behind the state's deposit count: the state's own data
    state.eth1_data_votes, jstate.eth1_data_votes = [], []
    state.eth1_data.deposit_count = jstate.eth1_data.deposit_count = tc.N + 5
    assert tracker.get_eth1_vote(state, 0).serialize() == state.eth1_data.serialize()
    assert jtracker.get_eth1_vote(jstate, 0).serialize() == state.eth1_data.serialize()


def _pow_chain(mod, tds):
    chain, parent = mod.PowProviderMock(), b"\x00" * 32
    for k, td in enumerate(tds):
        h = bytes([k + 1]) * 32
        chain.add_block(h, parent, td)
        parent = h
    return chain


@pytest.mark.parametrize("tds, ttd, terminal_hash", [
    ([10, 20, 30, 40], 25, b"\x00" * 32),   # crosses at the third block
    ([10, 20], 25, b"\x00" * 32),           # not yet
    ([30, 40], 25, b"\x00" * 32),           # the first block already above: its parent unknown
    ([10, 20, 30], 25, b"\x02" * 32),       # an explicit terminal block hash
    ([10, 20, 30], 25, b"\x09" * 32),       # an explicit hash the chain does not hold
])
def test_the_merge_tracker(tds, ttd, terminal_hash):
    results = []
    for mod in (mt, jmt):
        cfg = type("C", (), {"TERMINAL_TOTAL_DIFFICULTY": ttd, "TERMINAL_BLOCK_HASH": terminal_hash})
        tracker = mod.Eth1MergeBlockTracker(cfg, _pow_chain(mod, tds))
        found = tracker.get_terminal_pow_block()
        again = tracker.get_terminal_pow_block()
        valid = [tracker.is_valid_terminal_pow_block(b)
                 for b in tracker.provider.blocks.values()]
        results.append((None if found is None else dataclasses.astuple(found),
                        found is again, valid))
    assert results[0] == results[1]


def _abi_log(data, index, block_number):
    """An eth_getLogs entry of the deposit contract's DepositEvent."""
    fields = [bytes(data.pubkey), bytes(data.withdrawal_credentials),
              int(data.amount).to_bytes(8, "little"), bytes(data.signature),
              index.to_bytes(8, "little")]
    head, tail = b"", b""
    for f in fields:
        head += (5 * 32 + len(tail)).to_bytes(32, "big")
        tail += len(f).to_bytes(32, "big") + f + b"\x00" * (-len(f) % 32)
    return {"data": "0x" + (head + tail).hex(), "blockNumber": hex(block_number),
            "topics": [provider.DEPOSIT_EVENT_TOPIC]}


def _eth1_node(datas, head=40, truncate_over=4):
    """The JSON-RPC answers of an eth1 node holding one deposit per block
    from block 10 on; a range of more than `truncate_over` blocks fails
    (the provider halves it)."""
    logs = [_abi_log(d, i, 10 + i) for i, d in enumerate(datas)]

    def get_logs(params):
        frm, to = int(params[0]["fromBlock"], 16), int(params[0]["toBlock"], 16)
        if to - frm + 1 > truncate_over:
            raise ValueError("query returned more than 10000 results")
        return [lg for lg in logs if frm <= int(lg["blockNumber"], 16) <= to]

    def call(params):
        n = int(params[1], 16)
        count = sum(1 for lg in logs if int(lg["blockNumber"], 16) <= n)
        if params[0]["data"] == "0xc5f2892f":
            return "0x" + bytes([count]).rjust(32, b"\x00").hex()
        # get_deposit_count: ABI-encoded dynamic bytes8 (little-endian)
        return "0x" + ((32).to_bytes(32, "big") + (8).to_bytes(32, "big")
                       + count.to_bytes(8, "little").ljust(32, b"\x00")).hex()

    return {
        "eth_blockNumber": lambda params: hex(head),
        "eth_getLogs": get_logs,
        "eth_getBlockByNumber": lambda params: None if int(params[0], 16) > head else {
            "number": params[0], "hash": "0x" + int(params[0], 16).to_bytes(32, "big").hex(),
            "timestamp": hex(1000 + 14 * int(params[0], 16))},
        "eth_call": call,
    }


def _provider_calls(mod, types, port, config):
    p = mod.Eth1ProviderHttp(config, types, "127.0.0.1", port, deploy_block=8,
                             logs_batch_size=16, retries=1, retry_delay=0.0, timeout=5.0,
                             follow_distance=10)
    latest = p.latest_block_number()
    logs = p.get_deposit_logs(0, latest)
    block = p.get_block_by_number(25)
    return (latest, [(lg.index, lg.block_number, lg.deposit_data.serialize()) for lg in logs],
            dataclasses.astuple(block), p.get_block_by_number(99))


def test_the_http_provider_sends_the_jax_requests(deposits):
    datas, _ = deposits
    with torch_loopback.LoopbackServer(torch_loopback.jsonrpc(_eth1_node(datas))) as server:
        ours = _provider_calls(provider, T, server.port, tc.MINIMAL_CHAIN_CONFIG)
        mine = server.take()
        theirs = _provider_calls(jprovider, JT, server.port, tc.J_MINIMAL_CC)
        their_requests = server.take()
    assert ours == theirs and mine == their_requests
    latest, logs, block, missing = ours
    assert latest == 30 and missing is None
    # one deposit a block from block 10, every one of them at or below 30
    assert [lg[0] for lg in logs] == list(range(len(datas)))
    assert [lg[2] for lg in logs] == [d.serialize() for d in datas]
    assert block[3] == bytes([16]).rjust(32, b"\x00") and block[4] == 16
    # the 16-block ranges failed and were halved down to 4
    sizes = {int(r["body"]["params"][0]["toBlock"], 16)
             - int(r["body"]["params"][0]["fromBlock"], 16) + 1
             for r in mine if r["body"]["method"] == "eth_getLogs"}
    assert max(sizes) == 16 and 4 in sizes
    assert parse_equal(datas)


def parse_equal(datas) -> bool:
    lg = _abi_log(datas[3], 3, 13)
    ours, theirs = provider.parse_deposit_log(T, lg), jprovider.parse_deposit_log(JT, lg)
    return (ours.index, ours.block_number, ours.deposit_data.serialize()) == (
        theirs.index, theirs.block_number, theirs.deposit_data.serialize())
