"""The chain (the JAX package's `chain/`): the verifier boundary and the
serving stack over it (the facades and host tier, the supervisor, the lane
dispatcher), and `BeaconChain` with its fork choice, caches, pools,
regen and gossip validation."""

from .bls_verifier import CpuBlsVerifier, IBlsVerifier  # noqa: F401
from .chain import BeaconChain  # noqa: F401
from .supervisor import SupervisedBlsVerifier  # noqa: F401
from .prepare_next_slot import PrepareNextSlotScheduler  # noqa: F401
