"""Slot clock (reference: `chain/clock/LocalClock.ts` — wall-clock slot
ticking off genesisTime, gossip-disparity slot window)."""

from __future__ import annotations

import time
from typing import Callable

MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC = 0.5


class BeaconClock:
    """Time source → slot/epoch. `time_fn` is injectable (tests drive it
    manually; production uses time.time)."""

    def __init__(
        self,
        genesis_time: int,
        seconds_per_slot: int,
        slots_per_epoch: int,
        time_fn: Callable[[], float] = time.time,
    ):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.slots_per_epoch = slots_per_epoch
        self.time_fn = time_fn

    @property
    def current_slot(self) -> int:
        dt = self.time_fn() - self.genesis_time
        return max(0, int(dt // self.seconds_per_slot))

    @property
    def current_epoch(self) -> int:
        return self.current_slot // self.slots_per_epoch

    def slot_with_gossip_disparity(self) -> tuple[int, int]:
        """(earliest, latest) slot acceptable under the 500 ms gossip clock
        disparity (reference currentSlotWithGossipDisparity)."""
        t = self.time_fn() - self.genesis_time
        early = int((t + MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC) // self.seconds_per_slot)
        late = int((t - MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC) // self.seconds_per_slot)
        return (max(0, late), max(0, early))

    def is_current_slot_given_disparity(self, slot: int) -> bool:
        lo, hi = self.slot_with_gossip_disparity()
        return lo <= slot <= hi

    def time_at_slot(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        dt = self.time_fn() - self.genesis_time
        return dt % self.seconds_per_slot


class ManualClock(BeaconClock):
    """Deterministic clock for tests/sim: advance slots explicitly."""

    def __init__(self, genesis_time: int, seconds_per_slot: int, slots_per_epoch: int):
        self._now = float(genesis_time)
        super().__init__(
            genesis_time, seconds_per_slot, slots_per_epoch, time_fn=lambda: self._now
        )

    def set_slot(self, slot: int) -> None:
        self._now = self.genesis_time + slot * self.seconds_per_slot

    def advance_slot(self) -> None:
        self.set_slot(self.current_slot + 1)
