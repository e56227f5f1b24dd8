"""Stand-ins for the card's verifier, for the checks of the check itself.

- `ControlStack` puts the reference in the program's place with one of
  the configuration's guarantees broken (the control of `control.py`):
  `batch_verdict` hands every call of a coalesced batch the batch's
  verdict (no per-set fallback), `first_set` decides a call by its first
  set alone (a block's import taken on its gossip check's word).
- `PortStack` composes the port's own lanes and supervisor, as
  `build_bls_stack` does, over a device tier that answers from a table of
  the pool's valid sets in jobs of 128 sets, as the port's facade does,
  with one fault planted beneath them (the CPU tests under `tests/`):
  `altered` (every verdict True), `half` (the later half of each job left
  out), `unchanged` (each call answered with the previous call's verdict),
  `refuses` (every verdict False, which the supervisor's audit overturns
  until its breaker opens and the host tier answers in the card's place).
"""

from __future__ import annotations

import threading
import time

from . import bls_ref


def _raw(s):
    return (s.pubkey.to_bytes(), bytes(s.message), bytes(s.signature))


class _Counters:
    """The counter surface the harness reads, with nothing in it."""

    def supervisor_snapshot(self):
        return {"fallbacks": {}, "verdict_mismatches": 0}

    def stage_snapshot(self):
        return {}

    def planner_snapshot(self):
        return {"decisions": {}}


class _NoRegistry:
    def expose(self):
        return ""


class ControlStack:
    """The reference in the program's place, one guarantee broken. Its
    batches flush as the lanes' do by default: at 32 sets or 0.1 s."""

    flush_sets = 32
    flush_wait_s = 0.1

    def __init__(self, kind: str, reference: bls_ref.Reference):
        if kind not in ("batch_verdict", "first_set"):
            raise ValueError(f"unknown control {kind!r}")
        self.kind, self.ref = kind, reference
        self.pipeline, self.registry = _Counters(), _NoRegistry()
        self.verifier, self.supervisor, self.device = self, self, self
        self._cv = threading.Condition()
        self._queue: list = []  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._worker = threading.Thread(target=self._flush_loop, name="control-flush", daemon=True)
        self._worker.start()

    def populate_epoch_async(self, epoch, keys) -> bool:
        return True

    def wait_populated(self, timeout=None) -> bool:
        return True

    def verify_signature_sets(self, sets, batchable=True, lane="aggregate") -> bool:
        raw = [_raw(s) for s in sets]
        if self.kind == "first_set":
            return self.ref.sets_pass(raw[:1])
        box = {"done": threading.Event()}
        with self._cv:
            self._queue.append((raw, box, time.monotonic()))
            self._cv.notify()
        box["done"].wait()
        return box["verdict"]

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._ready_locked():
                    self._cv.wait(self.flush_wait_s / 4)
                if self._closed:
                    return
                batch, self._queue = self._queue, []
            verdict = self.ref.sets_pass([s for raw, _, _ in batch for s in raw])
            for _, box, _ in batch:
                box["verdict"] = verdict
                box["done"].set()

    def _ready_locked(self) -> bool:
        if not self._queue:
            return False
        if sum(len(r) for r, _, _ in self._queue) >= self.flush_sets:
            return True
        return time.monotonic() - self._queue[0][2] >= self.flush_wait_s

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(10)


class TableDevice:
    """A device tier that knows which sets are valid, with a planted fault.
    It answers in jobs of at most `job_sets` sets, stopping at the first
    False one, as the port's facade does."""

    FAULTS = (None, "altered", "half", "unchanged", "refuses")

    def __init__(self, valid: set, fault: str | None = None, job_sets: int = 128):
        if fault not in self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.valid, self.fault, self.job_sets = valid, fault, job_sets
        self._last = True

    def _ok(self, sets) -> bool:
        return all(_raw(s) in self.valid for s in sets)

    def _jobs(self, sets) -> list:
        sets = list(sets)
        return [sets[i: i + self.job_sets] for i in range(0, len(sets), self.job_sets)]

    def _job(self, sets) -> bool:
        if self.fault in ("altered", "refuses"):
            return self.fault == "altered"
        if self.fault == "half":
            return self._ok(sets[: (len(sets) + 1) // 2])
        return self._ok(sets)

    def verify_signature_sets(self, sets) -> bool:
        verdict = all(self._job(job) for job in self._jobs(sets))
        if self.fault == "unchanged":  # the call answered with the previous call's verdict
            verdict, self._last = self._last, verdict
        return verdict

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        out = []
        for job in self._jobs(sets):
            if self.fault in ("altered", "refuses"):
                out += [self.fault == "altered"] * len(job)
            elif self.fault == "half":
                keep = (len(job) + 1) // 2
                out += [self._ok([s]) if i < keep else True for i, s in enumerate(job)]
            else:
                out += [self._ok([s]) for s in job]
        return out

    def close(self) -> None:
        pass


class PortStack:
    """The port's `BlsLaneDispatcher` over its `SupervisedBlsVerifier` over
    `device`, with a host tier answering from the same table, built as
    `build_bls_stack` builds them."""

    def __init__(self, device, valid: set):
        from lodestar_tpu_torch.chain.dispatcher import BlsLaneDispatcher
        from lodestar_tpu_torch.chain.supervisor import SupervisedBlsVerifier
        from lodestar_tpu_torch.metrics.bls import create_bls_metrics
        from lodestar_tpu_torch.observability.stages import PipelineMetrics

        self.pipeline = PipelineMetrics()
        self.registry = self.pipeline.registry
        self.prom = create_bls_metrics(self.registry)
        self.device = device
        self.cpu = TableDevice(valid)
        self.supervisor = SupervisedBlsVerifier(device, self.cpu, observer=self.pipeline)
        self.verifier = BlsLaneDispatcher(self.supervisor, prom=self.prom, pipeline=self.pipeline)

    def populate_epoch_async(self, epoch, keys) -> bool:
        return True

    def wait_populated(self, timeout=None) -> bool:
        return True

    def close(self) -> None:
        self.verifier.close()
        self.supervisor.close()
