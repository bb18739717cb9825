"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA request without a card raises (there is
    no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def exact_f32() -> None:
    """f32 means f32 on the card: cuDNN convs and matmuls default to TF32
    otherwise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
