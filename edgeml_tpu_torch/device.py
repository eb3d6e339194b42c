"""Which device an entry point runs on, and exact f32 on it.

Entry points run on the CUDA device unless the caller asks for the CPU;
with no CUDA device and none asked for they raise, never falling back to a
silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the CUDA device. Raises when CUDA is wanted
    and absent — never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def exact_f32_cuda():
    """Turn TF32 off for f32 convolutions and matmuls (cuDNN convolutions
    default to TF32, which keeps about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
