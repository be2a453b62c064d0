"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no device given and no GPU present they raise: nothing quietly moves
to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
