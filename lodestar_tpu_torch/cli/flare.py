"""`flare` — beacon chain multi-purpose and debugging tool.

Reference: `packages/flare` (`flare/package.json:4`) with its two
commands `self-slash-proposer` / `self-slash-attester`
(`flare/src/cmds/selfSlashProposer.ts`, `selfSlashAttester.ts`): craft
valid slashing objects for validators whose keys you control (interop /
dev keys here) and submit them to a beacon node — the standard way to
exercise slashing processing on a testnet.

The port's copy of the JAX package's `cli/flare.py`: it signs on the C
host tier; the node it submits to runs each slashing's gossip validation,
whose signature sets a node on the card verifies there.
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER
from ..utils.logger import get_logger

log = get_logger("flare")


def _client(server: str):
    from urllib.parse import urlparse

    from ..api.client import BeaconApiClient

    parsed = urlparse(server if "//" in server else f"http://{server}")
    return BeaconApiClient(parsed.hostname, parsed.port or 5052)


def _setup(server: str, network: str):
    from ..config.beacon_config import BeaconConfig
    from ..config.chain_config import MAINNET_CHAIN_CONFIG, MINIMAL_CHAIN_CONFIG
    from ..params.presets import MAINNET, MINIMAL
    from ..types import get_types

    client = _client(server)
    genesis = client.getGenesis()
    root = bytes.fromhex(genesis["genesis_validators_root"].removeprefix("0x"))
    if network == "minimal-dev":
        config = BeaconConfig(MINIMAL_CHAIN_CONFIG, root, MINIMAL)
        types = get_types(MINIMAL).phase0
    else:
        config = BeaconConfig(MAINNET_CHAIN_CONFIG, root, MAINNET)
        types = get_types(MAINNET).phase0
    return client, config, types


def _parse_indices(spec: str) -> list[int]:
    """'0..4' or '1,3,7' → validator indices (interop keys)."""
    if ".." in spec:
        lo, hi = spec.split("..")
        return list(range(int(lo), int(hi)))
    return [int(x) for x in spec.split(",") if x]


def run_self_slash_proposer(args) -> int:
    """Sign two conflicting block headers per validator and submit
    ProposerSlashing objects (selfSlashProposer.ts)."""
    client, config, types = _setup(args.server, args.network)
    slot = int(args.slot)
    domain = config.get_domain(DOMAIN_BEACON_PROPOSER, slot)
    submitted = 0
    for index in _parse_indices(args.validators):
        sk = bls.interop_secret_key(index)
        headers = []
        for variant in (b"\x01", b"\x02"):
            header = types.BeaconBlockHeader(
                slot=slot,
                proposer_index=index,
                parent_root=b"\x00" * 32,
                state_root=b"\x00" * 32,
                body_root=variant * 32,
            )
            sig = sk.sign(compute_signing_root(header.hash_tree_root(), domain))
            headers.append(
                types.SignedBeaconBlockHeader(message=header, signature=sig.to_bytes())
            )
        slashing = types.ProposerSlashing(
            signed_header_1=headers[0], signed_header_2=headers[1]
        )
        client.submitPoolProposerSlashings(body=slashing.to_obj())
        submitted += 1
        log.info("self-slashed proposer %d at slot %d", index, slot)
    print(f"submitted {submitted} proposer slashings")
    return 0


def run_self_slash_attester(args) -> int:
    """Sign two attestations with the same target (double vote) per batch
    of validators and submit AttesterSlashing objects
    (selfSlashAttester.ts — batched across MAX_VALIDATORS_PER_COMMITTEE)."""
    client, config, types = _setup(args.server, args.network)
    slot = int(args.slot)
    epoch = slot // config.preset.SLOTS_PER_EPOCH
    domain = config.get_domain(
        DOMAIN_BEACON_ATTESTER,
        epoch * config.preset.SLOTS_PER_EPOCH,
        epoch,
    )
    indices = _parse_indices(args.validators)
    batch = max(1, int(args.batch_size))
    submitted = 0
    for off in range(0, len(indices), batch):
        group = sorted(indices[off : off + batch])
        atts = []
        for variant in (b"\x01", b"\x02"):
            data = types.AttestationData(
                slot=slot,
                index=0,
                beacon_block_root=variant * 32,
                source=types.Checkpoint(epoch=max(0, epoch - 1), root=b"\x00" * 32),
                target=types.Checkpoint(epoch=epoch, root=variant * 32),
            )
            root = compute_signing_root(data.hash_tree_root(), domain)
            sigs = [bls.interop_secret_key(i).sign(root) for i in group]
            atts.append(
                types.IndexedAttestation(
                    attesting_indices=group,
                    data=data,
                    signature=bls.aggregate_signatures(sigs).to_bytes(),
                )
            )
        slashing = types.AttesterSlashing(attestation_1=atts[0], attestation_2=atts[1])
        client.submitPoolAttesterSlashings(body=slashing.to_obj())
        submitted += 1
        log.info("self-slashed attesters %s at slot %d", group, slot)
    print(f"submitted {submitted} attester slashings")
    return 0


def add_flare_parser(sub) -> None:
    p = sub.add_parser(
        "flare", help="beacon chain multi-purpose and debugging tool"
    )
    flare_sub = p.add_subparsers(dest="flare_cmd", required=True)

    common = dict(
        server="beacon node REST endpoint (host[:port])",
        validators="interop validator indices: '0..4' or '1,3'",
    )
    sp = flare_sub.add_parser(
        "self-slash-proposer", help="submit double-proposal slashings for own keys"
    )
    sp.add_argument("--server", default="127.0.0.1:5052", help=common["server"])
    sp.add_argument("--network", default="minimal-dev")
    sp.add_argument("--validators", required=True, help=common["validators"])
    sp.add_argument("--slot", default="1")
    sp.set_defaults(func=run_self_slash_proposer)

    sa = flare_sub.add_parser(
        "self-slash-attester", help="submit double-vote slashings for own keys"
    )
    sa.add_argument("--server", default="127.0.0.1:5052", help=common["server"])
    sa.add_argument("--network", default="minimal-dev")
    sa.add_argument("--validators", required=True, help=common["validators"])
    sa.add_argument("--slot", default="1")
    sa.add_argument("--batch-size", default="32", dest="batch_size")
    sa.set_defaults(func=run_self_slash_attester)
