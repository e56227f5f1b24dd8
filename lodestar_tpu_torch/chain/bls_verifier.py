"""The device tier of the `IBlsVerifier` boundary (the JAX package's
`chain/bls_verifier.py::DeviceBlsVerifier`), over `TorchBlsVerifier`.

The JAX serving stack (`chain/supervisor.py::SupervisedBlsVerifier`,
`chain/dispatcher.py::BlsLaneDispatcher`) imports no JAX and calls these
seams on its device verifier, so it composes over this facade as it does
over the JAX one:

- `verify_signature_sets` and `verify_signature_sets_individual`, in jobs
  of at most `max_sets_per_job` sets (the JAX facade's `buckets[-1]`,
  128: the reference's chunkifyMaximizeChunkSize), each job inside a
  `trace.annotation` (`torch.profiler.record_function`) scope;
- `start_profiling(trace_dir)` / `stop_profiling()`, the process-wide
  `torch.profiler` switch of `observability.trace` (the JAX facade also
  starts a trace from LODESTAR_TPU_PROFILE; the port only when asked);
- `observer`, `h2c_cache_size`, `warm_h2c`, `epoch_table_populate` and
  `epoch_table_snapshot`, passed through to `TorchBlsVerifier`;
- the mesh and fleet seams (`mesh_evict`, `mesh_readmit`,
  `mesh_has_evicted`, `mesh_snapshot`, `mesh_evict_host`,
  `fleet_snapshot`, `fleet_attach_router`), passed through to
  `TorchBlsVerifier` and its `BlsMeshDispatcher`, if it has one; without
  one they answer as the JAX verifier does without a mesh (no eviction,
  nothing to readmit, no snapshot). Unlike the JAX facade, this one takes
  a `mesh` argument ("auto", a dispatcher or None) and a `fleet` argument
  (a `FleetTopology`, which the JAX facade reads from its environment)
  and passes them on; `close()` stops the mesh's worker processes.

Device decompression of the signatures is the default path; a batch
outside its 32 B root / 96 B signature shape is marshalled on the host,
and that downgrade is counted (`observer.decompress_fallback`) and
logged at most once a minute.
"""

from __future__ import annotations

import logging
import time

from ..observability import trace
from ..parallel.verifier import TorchBlsVerifier

MAX_SIGNATURE_SETS_PER_JOB = 128

_log = logging.getLogger("bls-verifier")


class DeviceBlsVerifier:
    """Device-tier verifier over the port's batch and per-set verdicts.

    `device` (default: the GPU; raises without one), `grouped_configs`,
    `pk_grouped_configs`, `observer` (default: the port's
    `default_pipeline()`), `faults`, `rng`, `mesh` and `fleet` go to
    `TorchBlsVerifier`; `max_sets_per_job` is the most sets one call of
    it verifies."""

    _FALLBACK_LOG_INTERVAL_S = 60.0

    def __init__(
        self,
        device=None,
        grouped_configs: tuple[tuple[int, int], ...] = ((16, 8), (64, 64)),
        pk_grouped_configs: tuple[tuple[int, int], ...] = ((128, 32),),
        max_sets_per_job: int = MAX_SIGNATURE_SETS_PER_JOB,
        observer=None,
        faults=None,
        rng=None,
        mesh="auto",
        fleet=None,
    ):
        self._inner = TorchBlsVerifier(
            device=device, grouped_configs=grouped_configs, rng=rng,
            pk_grouped_configs=pk_grouped_configs, observer=observer, faults=faults, mesh=mesh,
            fleet=fleet,
        )
        self.observer = self._inner.observer
        self.max_sets_per_job = int(max_sets_per_job)
        self._last_fallback_log = float("-inf")

    def _annotate(self, label: str):
        return trace.annotation(label)

    def start_profiling(self, trace_dir: str | None = None) -> str | None:
        """Start the process-wide trace; None if one is already running."""
        return trace.start_profiling(trace_dir)

    def stop_profiling(self) -> str | None:
        """Stop it and write its Chrome trace; returns the directory."""
        return trace.stop_profiling()

    def h2c_cache_size(self) -> int:
        return len(self._inner._h2c_cache)

    def close(self) -> None:
        """Stop the mesh's worker processes (none without a mesh)."""
        self._inner.close()

    # -- mesh and fleet seams (the supervisor's failure policy) ----------------

    def mesh_evict(self, chip: int | None = None, reason: str = "failure"):
        return self._inner.mesh_evict(chip=chip, reason=reason)

    def mesh_readmit(self) -> int:
        return self._inner.mesh_readmit()

    def mesh_has_evicted(self) -> bool:
        return self._inner.mesh_has_evicted()

    def mesh_snapshot(self):
        return self._inner.mesh_snapshot()

    def mesh_evict_host(self, host: int | None = None, reason: str = "failure"):
        return self._inner.mesh_evict_host(host=host, reason=reason)

    def fleet_snapshot(self):
        return self._inner.fleet_snapshot()

    def fleet_attach_router(self, router) -> None:
        self._inner.fleet_attach_router(router)

    # -- epoch-scoped precomputation -------------------------------------------

    def warm_h2c(self, messages) -> int:
        return self._inner.warm_h2c(messages)

    def epoch_table_populate(self, epoch: int, pubkeys) -> int:
        return self._inner.epoch_table_populate(epoch, pubkeys)

    def epoch_table_snapshot(self):
        return self._inner.epoch_table_snapshot()

    def _note_decompress_fallback(self, sets) -> None:
        """Count, and log at most once a minute, a batch that device
        decompression cannot take and the host marshals instead."""
        if not sets or not self._inner._device_decompress:
            return
        if self._inner._native_eligible(sets):
            return
        self.observer.decompress_fallback()
        now = time.monotonic()
        if now - self._last_fallback_log >= self._FALLBACK_LOG_INTERVAL_S:
            self._last_fallback_log = now
            _log.warning(
                "device-decompress batch (%d sets) fell back to host marshal: "
                "non-standard message/signature lengths; further downgrades counted "
                "by observer.decompress_fallback", len(sets),
            )

    # -- verdicts ----------------------------------------------------------------

    def verify_signature_sets(self, sets) -> bool:
        sets = list(sets)
        if not sets:
            return False
        self._note_decompress_fallback(sets)
        with self._annotate(f"bls_verify_batch/{len(sets)}"):
            for i in range(0, len(sets), self.max_sets_per_job):
                if not self._inner.verify_signature_sets(sets[i: i + self.max_sets_per_job]):
                    return False
            return True

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        sets = list(sets)
        self._note_decompress_fallback(sets)
        out: list[bool] = []
        with self._annotate(f"bls_verify_individual/{len(sets)}"):
            for i in range(0, len(sets), self.max_sets_per_job):
                out.extend(self._inner.verify_signature_sets_individual(
                    sets[i: i + self.max_sets_per_job]))
        return out
