"""The process's runtime identity for the `lodestar_tpu_build_info` gauge
(`PipelineMetrics.set_build_info`), in place of the JAX package's
`utils/jax_env.runtime_info`."""

from __future__ import annotations

import torch


def runtime_info() -> dict:
    """torch and CUDA versions, backend (`cuda` or `cpu`), device kind and
    count, mesh divisor (1: the port dispatches to one device) and the
    extension build directory as `compile_cache`. Every value is a string
    (they ride Prometheus labels)."""
    from ..build import BUILD_DIR

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": str(torch.cuda.device_count() if cuda else 1),
        "mesh_divisor": "1",
        "compile_cache": BUILD_DIR,
    }
