"""BeaconNode: the composition root, and the serving stack it composes.

Reference: `beacon-node/src/node/nodejs.ts:127-270` — `BeaconNode.init()`
wires db → metrics → chain → network → sync → api → servers, and `close()`
persists caches; `node/notifier.ts` logs per-slot status lines. The port's
copy of the JAX package's `node/`, with the verifier stack a beacon node
composes in `bls_stack.build_bls_stack` (the JAX `node/node.py:103-152`).
"""

from .node import BeaconNode, NodeOptions  # noqa: F401
from .init_state import init_beacon_state  # noqa: F401
from .notifier import NodeNotifier  # noqa: F401
