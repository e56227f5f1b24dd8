"""Multi-node simulation harness.

Reference: `cli/test/utils/simulation/` — `SimulationEnvironment` spawns
{N beacon nodes × M validators} in one process over real networking,
runs epochs, and asserts per-epoch liveness invariants (missed blocks,
participation, finality, head consistency) — `simulation.test.ts:18-90`
and `simTestInfoTracker` (`test/utils/node/simTest.ts:20-60`). The port's
copy of the JAX package's `sim/`.
"""

from .environment import (  # noqa: F401
    EpochReport,
    SimNode,
    SimulationAssertions,
    SimulationEnvironment,
)
