"""Typed Beacon API route table.

Reference: `api/src/beacon/routes/{beacon,node,validator,config,debug}.ts`
— each route = (method, path template, handler name). The server binds
handler names to an implementation object (`api/impl` equivalent:
`api.impl.BeaconApiImpl`); the client generates request
methods from the same table. The port's copy of the JAX package's
`api/routes.py`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Route:
    operation_id: str
    method: str  # GET | POST
    path: str    # /eth/v1/... with {param} templates


API_ROUTES: list[Route] = [
    # beacon (routes/beacon/*)
    Route("getGenesis", "GET", "/eth/v1/beacon/genesis"),
    Route("getStateRoot", "GET", "/eth/v1/beacon/states/{state_id}/root"),
    Route("getStateFinalityCheckpoints", "GET", "/eth/v1/beacon/states/{state_id}/finality_checkpoints"),
    Route("getStateValidators", "GET", "/eth/v1/beacon/states/{state_id}/validators"),
    Route("getStateValidator", "GET", "/eth/v1/beacon/states/{state_id}/validators/{validator_id}"),
    Route("getBlockHeader", "GET", "/eth/v1/beacon/headers/{block_id}"),
    Route("getBlockV2", "GET", "/eth/v2/beacon/blocks/{block_id}"),
    Route("getBlockRoot", "GET", "/eth/v1/beacon/blocks/{block_id}/root"),
    Route("publishBlock", "POST", "/eth/v1/beacon/blocks"),
    Route("submitPoolAttestations", "POST", "/eth/v1/beacon/pool/attestations"),
    Route("submitPoolVoluntaryExit", "POST", "/eth/v1/beacon/pool/voluntary_exits"),
    Route("submitPoolProposerSlashings", "POST", "/eth/v1/beacon/pool/proposer_slashings"),
    Route("submitPoolAttesterSlashings", "POST", "/eth/v1/beacon/pool/attester_slashings"),
    Route("getPoolProposerSlashings", "GET", "/eth/v1/beacon/pool/proposer_slashings"),
    Route("getPoolAttesterSlashings", "GET", "/eth/v1/beacon/pool/attester_slashings"),
    # node (routes/node.ts)
    Route("getNodeVersion", "GET", "/eth/v1/node/version"),
    Route("getNodeIdentity", "GET", "/eth/v1/node/identity"),
    Route("getNodePeers", "GET", "/eth/v1/node/peers"),
    Route("getSyncingStatus", "GET", "/eth/v1/node/syncing"),
    Route("getHealth", "GET", "/eth/v1/node/health"),
    # config (routes/config.ts)
    Route("getSpec", "GET", "/eth/v1/config/spec"),
    Route("getDepositContract", "GET", "/eth/v1/config/deposit_contract"),
    # validator (routes/validator.ts)
    Route("getAttesterDuties", "POST", "/eth/v1/validator/duties/attester/{epoch}"),
    Route("getProposerDuties", "GET", "/eth/v1/validator/duties/proposer/{epoch}"),
    Route("produceBlockV2", "GET", "/eth/v2/validator/blocks/{slot}"),
    Route("produceAttestationData", "GET", "/eth/v1/validator/attestation_data"),
    Route("getAggregatedAttestation", "GET", "/eth/v1/validator/aggregate_attestation"),
    Route("publishAggregateAndProofs", "POST", "/eth/v1/validator/aggregate_and_proofs"),
    Route("getLiveness", "POST", "/eth/v1/validator/liveness/{epoch}"),
    Route("prepareBeaconProposer", "POST", "/eth/v1/validator/prepare_beacon_proposer"),
    # debug (routes/debug.ts)
    Route("getDebugChainHeadsV2", "GET", "/eth/v2/debug/beacon/heads"),
    Route("getStateV2", "GET", "/eth/v2/debug/beacon/states/{state_id}"),
    # light client (routes/lightclient.ts)
    Route("getLightClientBootstrap", "GET", "/eth/v1/beacon/light_client/bootstrap/{block_root}"),
    Route("getLightClientUpdatesByRange", "GET", "/eth/v1/beacon/light_client/updates"),
    Route("getLightClientFinalityUpdate", "GET", "/eth/v1/beacon/light_client/finality_update"),
    Route("getLightClientOptimisticUpdate", "GET", "/eth/v1/beacon/light_client/optimistic_update"),
]

ROUTES_BY_ID = {r.operation_id: r for r in API_ROUTES}


def match_route(method: str, path: str):
    """Match a concrete request path against the table → (route, params)."""
    parts = path.rstrip("/").split("/")
    for route in API_ROUTES:
        if route.method != method:
            continue
        tparts = route.path.split("/")
        if len(tparts) != len(parts):
            continue
        params = {}
        ok = True
        for t, p in zip(tparts, parts):
            if t.startswith("{") and t.endswith("}"):
                params[t[1:-1]] = p
            elif t != p:
                ok = False
                break
        if ok:
            return route, params
    return None, {}
