"""Sync (SURVEY.md §2.2 `sync/`): range sync, unknown-block sync.

Reference: `sync/sync.ts` orchestrator — RangeSync (per-target SyncChains
of epoch batches with peer balancing, `range/`), UnknownBlockSync
(fetch-by-root for unknown parents, `unknownBlock.ts`), BackfillSync.
Peers are anything speaking the req/resp surface (`IPeer`), so tests wire
two in-process nodes through the real wire codec.

The port's copy of the JAX package's `sync/`, over the port's network
codec and chain; `backfill` checks proposer signatures with the port's
`bls/api.py`.
"""

from .range_sync import BatchStatus, RangeSync, SyncBatch  # noqa: F401
from .unknown_block import UnknownBlockSync  # noqa: F401
from .peer import IPeer, LocalPeer  # noqa: F401
