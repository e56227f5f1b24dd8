"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
device given they take `cuda` and raise when there is none, rather than
running on the CPU unasked.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
