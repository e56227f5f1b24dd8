"""The consensus state transition of block import, on the host.

The port's copy of `lodestar_tpu/state_transition`: phase0, Altair,
Bellatrix and Capella (`stf`, `block`, `epoch`, `altair`, `bellatrix`,
`capella`), the flat validator columns and epoch caches (`cache`), the
incremental state root (`hasher`), genesis (`genesis`), weak
subjectivity (`weak_subjectivity`) and every signature-set producer
(`signature_sets`). It runs on numpy and the C host tier; the verdict
over a block's sets is the device's (`profile_block`).

All consensus arithmetic is host ints / numpy uint64 — never floats.
"""

from .cache import EpochContext, FlatValidators, CachedBeaconState  # noqa: F401
from .stf import state_transition, process_slots  # noqa: F401
from .genesis import (  # noqa: F401
    initialize_beacon_state_from_eth1,
    interop_genesis_state,
)
