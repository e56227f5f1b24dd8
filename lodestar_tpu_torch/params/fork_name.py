"""Fork names and ordering.

Equivalent of packages/params/src/forkName.ts (`ForkName`,
`ForkSeq`): the ordered list of consensus forks this framework implements.
"""

from __future__ import annotations

from enum import IntEnum


class ForkSeq(IntEnum):
    """Fork sequence number — totally ordered, usable for `>=` gating."""

    phase0 = 0
    altair = 1
    bellatrix = 2
    capella = 3


class ForkName:
    phase0 = "phase0"
    altair = "altair"
    bellatrix = "bellatrix"
    capella = "capella"


FORK_ORDER: tuple[str, ...] = (
    ForkName.phase0,
    ForkName.altair,
    ForkName.bellatrix,
    ForkName.capella,
)

# Forks at/after which blocks carry an execution payload
EXECUTION_FORKS = frozenset({ForkName.bellatrix, ForkName.capella})
# Forks at/after which light-client (sync committee) data exists
LIGHT_CLIENT_FORKS = frozenset({ForkName.altair, ForkName.bellatrix, ForkName.capella})
# Forks with withdrawals
WITHDRAWAL_FORKS = frozenset({ForkName.capella})


def fork_seq(fork: str) -> ForkSeq:
    return ForkSeq[fork]


def highest_fork(forks: list[str]) -> str:
    return max(forks, key=lambda f: ForkSeq[f])
