"""Validator client: the port's copy of the JAX package's `validator/`.

Reference surface: `Validator` (validator.ts:53), `ValidatorStore` with
slashing-protection-gated signing (`services/validatorStore.ts:307+`),
duty services (attestationDuties.ts / attestation.ts / block.ts),
EIP-3076 slashing protection (`slashingProtection/`).

`ValidatorService` runs the duties in-process against a `BeaconChain`,
`RestValidatorService` over the Beacon API (`api/client.py`); signing and
protection logic is transport-independent. The validator does no device
work: it signs on the host tier's C BLS, and the beacon node's verdicts on
the blocks it proposes run on the card. Keystores (`keystore.py`) decrypt
with the host tier's C AES-128-CTR.
"""

from .store import ValidatorStore  # noqa: F401
from .slashing_protection import SlashingProtection, SlashingError  # noqa: F401
from .service import ValidatorService  # noqa: F401
from .rest_service import RestValidatorService  # noqa: F401
from .doppelganger import DoppelgangerService, DoppelgangerStatus  # noqa: F401
from .external_signer import ExternalSignerClient, ExternalSignerServer  # noqa: F401
