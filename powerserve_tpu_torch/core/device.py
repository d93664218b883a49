"""Device selection for the port's entry points.

Entry points put their tensors on the GPU unless the caller asks for the
CPU: device=None means "cuda", and asking for CUDA on a machine without
a GPU raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
