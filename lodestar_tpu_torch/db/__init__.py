"""Key-value DB abstraction with bucket-prefixed keys + typed repositories.

Reference: `packages/db` — `IDatabaseController` over LevelDB
(`controller/level.ts`), `Repository<Id, T>` with SSZ encode/decode
(`abstractRepository.ts`), `Bucket` enum (`schema.ts:5-70`). Backends:
`MemoryDb` (dict-backed; the reference uses one for tests too) and
`FileDb` — an append-only-log + in-memory-index store in the same spirit
as LevelDB's design, pure stdlib.
"""

from .controller import FileDb, IDatabaseController, MemoryDb  # noqa: F401
from .repository import Bucket, Repository  # noqa: F401
from .beacon import BeaconDb  # noqa: F401
