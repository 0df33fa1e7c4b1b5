"""The port's device rule, shared by its entry points and factories."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; without one, raise rather than run
    on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
