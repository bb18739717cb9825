"""Where the port runs: the card unless the caller asks for the CPU; the
tools' refusal of a host without CUDA, and the card's name."""

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


def tool_device(tool: str, device: str) -> torch.device:
    """`resolve_device` for a tool's command line: a CUDA request without a
    card exits naming the tool, as the JAX tools refuse a backend that is
    not the chip."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; this tool measures the "
                         "card (pass --device cpu to run it on the CPU)")
    return resolve_device(device)


def card_name(device: torch.device) -> str | None:
    """nvidia-smi's `name, power.limit` of the card, None for the CPU."""
    if device.type != "cuda":
        return None
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[device.index or 0].strip() if lines else None
