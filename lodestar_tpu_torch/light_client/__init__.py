"""Light client (SURVEY.md §2.1 `light-client` + §2.2 `chain/lightClient/`),
the port's copy of the JAX package's `light_client/`.

Server side (`LightClientServer`): derives sync-committee-signed updates
at block import — bootstrap (header + current committee + proof), best
`LightClientUpdate` per sync period, finality/optimistic updates
(reference: `chain/lightClient/index.ts:153,208`, proofs.ts).

Client side (`Lightclient`): follows the chain from a trusted block root
with nothing but headers, merkle proofs and sync-aggregate signatures
(reference: `light-client/src/index.ts`, validation.ts), the signatures
checked on the C host tier; `rest_follow.RestLightclientFollower` drives
it over a node's Beacon API and event stream.
"""

from .server import LightClientServer  # noqa: F401
from .client import Lightclient, LightClientError  # noqa: F401
