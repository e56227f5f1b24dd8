"""LMD-GHOST + Casper FFG fork choice (SURVEY.md §2 `fork-choice`).

Reference: `packages/fork-choice` — `ProtoArray` (protoArray.ts),
`computeDeltas` (computeDeltas.ts), `ForkChoice` (forkChoice.ts). Here the
vote/delta bookkeeping is flat numpy arrays (validator-indexed), so the
per-epoch delta computation is two `bincount`s instead of a JS loop.
"""

from .proto_array import ProtoArray, ProtoNode  # noqa: F401
from .fork_choice import ForkChoice, ForkChoiceStore  # noqa: F401
