"""Doppelganger protection (the port's copy of the JAX package's
`validator/doppelganger.py`).

Reference: `validator/src/services/doppelgangerService.ts` — before a
validator starts signing, watch the network for DOPPELGANGER_EPOCHS_TO_CHECK
full epochs; any liveness sighting of our indices (attestation or proposal
by someone else holding the same key) permanently blocks signing.
"""

from __future__ import annotations

from enum import Enum

from ..utils.logger import get_logger

DOPPELGANGER_EPOCHS_TO_CHECK = 2


class DoppelgangerStatus(str, Enum):
    VERIFYING = "VerifyingSafety"
    SAFE = "SigningEnabled"
    DETECTED = "DoppelgangerDetected"


class DoppelgangerService:
    """`register(index, epoch)` when a key is added; call
    `on_epoch(epoch, liveness)` once per epoch with a liveness map
    (validator_index → seen-this-epoch) from the beacon node's liveness
    endpoint; gate every signing path on `is_signing_safe`."""

    def __init__(self, epochs_to_check: int = DOPPELGANGER_EPOCHS_TO_CHECK):
        self.epochs_to_check = epochs_to_check
        self.log = get_logger("doppelganger")
        # index → (registered_epoch, status)
        self._state: dict[int, tuple[int, DoppelgangerStatus]] = {}

    def register(self, validator_index: int, current_epoch: int) -> None:
        self._state.setdefault(
            validator_index, (current_epoch, DoppelgangerStatus.VERIFYING)
        )

    def status(self, validator_index: int) -> DoppelgangerStatus:
        entry = self._state.get(validator_index)
        # unregistered indices are assumed managed elsewhere: signing allowed
        return entry[1] if entry else DoppelgangerStatus.SAFE

    def is_signing_safe(self, validator_index: int) -> bool:
        return self.status(validator_index) == DoppelgangerStatus.SAFE

    def any_detected(self) -> bool:
        return any(
            st == DoppelgangerStatus.DETECTED for _, st in self._state.values()
        )

    def on_epoch(self, epoch: int, liveness: dict[int, bool]) -> None:
        """`liveness[idx]` True = the network saw idx attest/propose this
        epoch. Sightings during VERIFYING mean another instance holds the
        key → DETECTED (never signs). After `epochs_to_check` clean epochs
        → SAFE."""
        for idx, (registered, status) in list(self._state.items()):
            if status != DoppelgangerStatus.VERIFYING:
                continue
            if liveness.get(idx, False):
                self.log.error(
                    "DOPPELGANGER DETECTED for validator %d — signing disabled",
                    idx,
                )
                self._state[idx] = (registered, DoppelgangerStatus.DETECTED)
            elif epoch >= registered + self.epochs_to_check:
                self.log.info("validator %d cleared doppelganger check", idx)
                self._state[idx] = (registered, DoppelgangerStatus.SAFE)
