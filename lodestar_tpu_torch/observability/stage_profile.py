"""Per-stage device time of the grouped verdict (the JAX package's
`observability/stage_profile.py`).

The port's verdict functions run stage by stage, each stage a run of
asynchronous launches, so a host timer sees a stage's dispatch and not
its device time. `profile_stages` runs `grouped_verify_kernel_raw`
through its `stage=` hook with a clock that records a CUDA event on the
current stream at each stage's start and end, synchronises once after
the last repetition, and observes each stage's mean device seconds into
a `PipelineMetrics` stage histogram under the JAX package's stage names
(the G1 and G2 bit-plane MSMs together as `msm_planes`; `plane_subgroup`,
which the JAX verdict does not time apart, under its own name). The same
verdict function runs, so there is no second copy of the arithmetic. On
the CPU the clock is the host's.

Inputs are deterministic random field elements, bits and signature bytes:
stage TIMING does not depend on the values. (The verdicts are
meaningless; nothing here checks them.) `python3 -m
lodestar_tpu_torch.profile_verdict` is the fuller breakdown, with a
synchronise around each stage, the launch counts and a profiler pass.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..device import resolve_device
from .stages import PipelineMetrics, default_pipeline

N_LIMBS = 32
HALF_BITS = 32
LANES = 4  # lanes per row: `batch` lanes are batch // 4 rows of 4

# the grouped verdict's stage names -> the JAX package's stage names
STAGE_NAMES = {
    "g2_decompress": "g2_decompress",
    "msm_g1": "msm_planes",
    "msm_g2": "msm_planes",
    "miller_loop": "miller_loop",
    "product_tree": "product_tree",
    "final_exp": "final_exp",
    "plane_subgroup": "plane_subgroup",
}


def _rand_inputs(rows: int, device, seed: int = 7) -> tuple:
    """The grouped raw verdict's inputs at (rows, LANES): field elements
    in [0, p) as limbs, 96-byte signatures with the compression flag set,
    random coefficient bits, every lane valid."""
    from ..bls.fields import P
    from ..ops.limbs import int_to_limbs

    rng = np.random.default_rng(seed)

    def fp_limbs(*shape):
        n = int(np.prod(shape))
        vals = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)]
        return np.stack([int_to_limbs(v) for v in vals]).reshape(shape + (N_LIMBS,))

    sig_raw = rng.integers(0, 256, size=(rows, LANES, 96), dtype=np.uint8)
    sig_raw[..., 0] = (sig_raw[..., 0] & 0x1F) | 0x80
    arrays = (
        fp_limbs(rows, LANES), fp_limbs(rows, LANES),
        fp_limbs(rows, 2), fp_limbs(rows, 2), sig_raw,
        rng.integers(0, 2, size=(rows, LANES, HALF_BITS), dtype=np.int32),
        rng.integers(0, 2, size=(rows, LANES, HALF_BITS), dtype=np.int32),
        np.ones((rows, LANES), bool),
    )
    return tuple(torch.as_tensor(a).to(device) for a in arrays)


class _StageClock:
    """The `stage=` hook: CUDA events around each stage on a CUDA device
    (read after one synchronise), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans: list[tuple[str, object, object]] = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    @contextlib.contextmanager
    def stage(self, name: str):
        start = self._now()
        yield
        self.spans.append((name, start, self._now()))

    def seconds(self) -> dict[str, float]:
        """Seconds per stage name, summed over every span."""
        out: dict[str, float] = {}
        if self.cuda and self.spans:
            self.spans[-1][2].synchronize()
        for name, start, end in self.spans:
            secs = start.elapsed_time(end) / 1e3 if self.cuda else end - start
            out[name] = out.get(name, 0.0) + secs
        return out


def profile_stages(
    pipeline: PipelineMetrics | None = None,
    batch: int = 256,
    reps: int = 2,
    device=None,
) -> dict:
    """Time each stage of the grouped verdict at `batch` lanes (batch // 4
    rows of 4), on a CUDA device after one warm-up call; returns {stage:
    mean seconds} under the JAX package's stage names and observes each
    into the stage histogram of `pipeline` (default: `default_pipeline()`).
    `batch` must be a multiple of 4 (the MSMs' subset-4 tables); `device`
    resolves as the verifier's does (default: the GPU)."""
    from ..parallel.verifier import grouped_verify_kernel_raw

    if batch % LANES != 0:
        raise ValueError("batch must be a multiple of 4")
    obs = pipeline if pipeline is not None else default_pipeline()
    dev = resolve_device(device)
    inputs = _rand_inputs(batch // LANES, dev)
    if dev.type == "cuda":
        bool(grouped_verify_kernel_raw(*inputs))  # builds and loads the kernels
    clock = _StageClock(dev)
    for _ in range(reps):
        grouped_verify_kernel_raw(*inputs, stage=clock.stage)
    results: dict[str, float] = {}
    for name, secs in clock.seconds().items():
        stage = STAGE_NAMES[name]
        results[stage] = results.get(stage, 0.0) + secs / reps
    for stage, secs in results.items():
        obs.observe_stage(stage, secs)
    return {k: round(v, 6) for k, v in results.items()}
