"""Device resolution shared by every entry point of the port.

An entry point runs on the CUDA card unless its caller asks for the CPU.
With no card and no explicit ``device="cpu"`` it raises: the port never
moves work to the CPU behind its caller's back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as asked. A CUDA
    device without an index gets the current one, so equal requests give
    equal devices.

    Raises ``RuntimeError`` when CUDA is asked for (or implied) and this
    process sees no CUDA device.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
