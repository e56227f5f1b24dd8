"""Genesis state construction + interop genesis.

The port's copy of `lodestar_tpu/state_transition/genesis.py`: spec
`initialize_beacon_state_from_eth1` plus the deterministic interop path the
reference uses for dev/sim networks (`state-transition/src/util/interop.ts`;
genesis builder reference: `beacon-node/src/chain/genesis/genesis.ts`).

It gives the JAX module's bytes at any size, at O(n log n) instead of its
O(n²): the deposit tree is the deposit contract's incremental one (a
branch of the last left node at each height), so a root and the proof of
the newest leaf cost O(depth) hashes each; genesis looks pubkeys up in a
dict; and the deposits' signatures are checked up front, across threads
of the C host tier, since a deposit's verdict does not depend on the
state.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from ..bls.api import DST_G2, interop_secret_key
from ..config.beacon_config import compute_domain, compute_signing_root
from ..params import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DOMAIN_DEPOSIT,
    GENESIS_EPOCH,
)
from ..ssz.hashing import sha256
from .block import apply_deposit_data
from .util import is_valid_merkle_branch


class DepositTree:
    """Incremental depth-32 merkle tree (the deposit-contract algorithm):
    append leaves, read the root and the proof of the newest leaf at
    O(depth) hashes each, or the proof of any leaf at O(leaves). Proofs
    include the trailing length mix-in (depth+1 branch) per the spec
    layout."""

    def __init__(self, depth: int = DEPOSIT_CONTRACT_TREE_DEPTH):
        self.depth = depth
        self.zero_hashes = [b"\x00" * 32]
        for _ in range(depth):
            self.zero_hashes.append(sha256(self.zero_hashes[-1] + self.zero_hashes[-1]))
        # branch[h]: the newest complete left node at height h
        self.branch = list(self.zero_hashes[:depth])
        self.count = 0
        self.leaves: list[bytes] = []
        self._levels: list[list[bytes]] | None = None  # proof()'s, at len(leaves)

    def append(self, leaf: bytes) -> None:
        self.leaves.append(leaf)
        self._levels = None
        self.count += 1
        size, node = self.count, leaf
        for h in range(self.depth):
            if size & 1:
                self.branch[h] = node
                return
            node = sha256(self.branch[h] + node)
            size >>= 1

    def root(self) -> bytes:
        """Root including the uint256-length mix-in (deposit contract
        `get_deposit_root`)."""
        node, size = self.zero_hashes[0], self.count
        for h in range(self.depth):
            if size & 1:
                node = sha256(self.branch[h] + node)
            else:
                node = sha256(node + self.zero_hashes[h])
            size >>= 1
        return sha256(node + self.count.to_bytes(32, "little"))

    def last_proof(self) -> list[bytes]:
        """Branch of the newest leaf against `root()` — depth+1 elements,
        the last being the length mix-in. Its sibling at height h is the
        complete left node there when the leaf's path turns right, else
        the empty subtree."""
        i = self.count - 1
        branch = [
            self.branch[h] if (i >> h) & 1 else self.zero_hashes[h]
            for h in range(self.depth)
        ]
        branch.append(self.count.to_bytes(32, "little"))
        return branch

    def proof(self, index: int) -> list[bytes]:
        """Branch of leaf `index` against `root()` — depth+1 elements, the
        last being the length mix-in. The tree's levels are built once per
        leaf count, so the proofs of a block's deposits share them."""
        if not 0 <= index < self.count:
            raise IndexError(f"leaf {index} of {self.count}")
        if self._levels is None:
            nodes, self._levels = list(self.leaves), []
            for h in range(self.depth):
                if len(nodes) % 2:
                    nodes.append(self.zero_hashes[h])
                self._levels.append(nodes)
                nodes = [sha256(nodes[i] + nodes[i + 1]) for i in range(0, len(nodes), 2)]
        branch = []
        for h, nodes in enumerate(self._levels):
            sibling = (index >> h) ^ 1
            branch.append(nodes[sibling] if sibling < len(nodes) else self.zero_hashes[h])
        branch.append(self.count.to_bytes(32, "little"))
        return branch


def _deposit_signing_root(config, types, data) -> bytes:
    domain = compute_domain(DOMAIN_DEPOSIT, config.GENESIS_FORK_VERSION, b"\x00" * 32)
    msg = types.DepositMessage(
        pubkey=bytes(data.pubkey),
        withdrawal_credentials=bytes(data.withdrawal_credentials),
        amount=data.amount,
    )
    return compute_signing_root(msg.hash_tree_root(), domain)


def verify_deposit_signatures(config, types, datas, threads: int | None = None) -> list[bool]:
    """Each DepositData's proof of possession on the C host tier (KeyValidate
    of the key, the signature's subgroup check, the pairing), split across
    threads."""
    from .. import native

    if not datas:
        return []
    roots = [_deposit_signing_root(config, types, d) for d in datas]
    return native.verify_sets(
        b"".join(bytes(d.pubkey) for d in datas), roots,
        b"".join(bytes(d.signature) for d in datas), DST_G2,
        threads=threads or os.cpu_count() or 1,
    )


def initialize_beacon_state_from_eth1(
    config, types, eth1_block_hash: bytes, eth1_timestamp: int, deposits
):
    """Spec initialize_beacon_state_from_eth1 (phase0 types namespace)."""
    p = config.preset
    state = types.BeaconState()
    state.genesis_time = eth1_timestamp + config.GENESIS_DELAY
    state.fork = types.Fork(
        previous_version=config.GENESIS_FORK_VERSION,
        current_version=config.GENESIS_FORK_VERSION,
        epoch=GENESIS_EPOCH,
    )
    state.eth1_data = types.Eth1Data(
        deposit_root=b"\x00" * 32,
        deposit_count=len(deposits),
        block_hash=eth1_block_hash,
    )
    body_root = types.BeaconBlockBody().hash_tree_root()
    state.latest_block_header = types.BeaconBlockHeader(body_root=body_root)
    state.randao_mixes = [eth1_block_hash] * p.EPOCHS_PER_HISTORICAL_VECTOR

    # process deposits against an incrementally-updated deposit root
    sig_ok = verify_deposit_signatures(config, types, [d.data for d in deposits])
    pubkey_index: dict[bytes, int] = {}
    tree = DepositTree()
    for i, deposit in enumerate(deposits):
        leaf = deposit.data.hash_tree_root()
        tree.append(leaf)
        state.eth1_data.deposit_root = tree.root()
        # genesis deposits: proof verified against the incremental root
        assert is_valid_merkle_branch(
            leaf,
            list(deposit.proof),
            DEPOSIT_CONTRACT_TREE_DEPTH + 1,
            i,
            state.eth1_data.deposit_root,
        ), f"invalid genesis deposit proof at {i}"
        state.eth1_deposit_index += 1
        apply_deposit_data(config, types, state, deposit.data, pubkey_index, sig_ok[i])

    # activate validators with full effective balance
    for v in state.validators:
        if v.effective_balance == p.MAX_EFFECTIVE_BALANCE:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH
    validators_type = dict(type(state).fields)["validators"]
    state.genesis_validators_root = validators_type.hash_tree_root(state.validators)
    return state


def is_valid_genesis_state(config, state) -> bool:
    if state.genesis_time < config.MIN_GENESIS_TIME:
        return False
    active = sum(
        1 for v in state.validators if v.activation_epoch == GENESIS_EPOCH
    )
    return active >= config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT


def make_interop_deposits(config, types, n: int, amount: int | None = None,
                          threads: int | None = None):
    """Deterministic interop deposits: keys via `interop_secret_key(i)`,
    BLS withdrawal credentials, signed DepositMessages (keys and signatures
    from the C host tier, across threads), and for deposit i the proof
    against the tree of deposits 0..i, which genesis processing checks it
    against."""
    p = config.preset
    amount = amount if amount is not None else p.MAX_EFFECTIVE_BALANCE
    domain = compute_domain(DOMAIN_DEPOSIT, config.GENESIS_FORK_VERSION, b"\x00" * 32)

    def one(i):
        sk = interop_secret_key(i)
        pk = sk.to_public_key().to_bytes()
        wc = b"\x00" + sha256(pk)[1:]
        msg = types.DepositMessage(
            pubkey=pk, withdrawal_credentials=wc, amount=amount
        )
        sig = sk.sign(compute_signing_root(msg.hash_tree_root(), domain))
        return types.DepositData(
            pubkey=pk,
            withdrawal_credentials=wc,
            amount=amount,
            signature=sig.to_bytes(),
        )

    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        datas = list(pool.map(one, range(n)))
    deposits = []
    tree = DepositTree()
    for data in datas:
        tree.append(data.hash_tree_root())
        deposits.append(types.Deposit(proof=tree.last_proof(), data=data))
    return deposits


def interop_genesis_state(config, types, n_validators: int, genesis_time: int = 0):
    """Dev/sim genesis on interop keys (reference: `dev` command path,
    `cli/src/cmds/dev` + interop state)."""
    deposits = make_interop_deposits(config, types, n_validators)
    state = initialize_beacon_state_from_eth1(
        config, types, b"\x42" * 32, max(0, genesis_time - config.GENESIS_DELAY), deposits
    )
    if genesis_time:
        state.genesis_time = genesis_time
    return state
