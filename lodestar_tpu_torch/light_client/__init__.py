"""Light client, server side (the JAX package's `light_client/server.py`).

`LightClientServer` derives sync-committee-signed updates at block
import — bootstrap (header + current committee + proof), best
`LightClientUpdate` per sync period, finality/optimistic updates
(reference: `chain/lightClient/index.ts:153,208`, proofs.ts). The client
side is not ported.
"""

from .server import LightClientServer  # noqa: F401
