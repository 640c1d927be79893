"""What every kernel wrapper of the port checks and passes around its ctypes
launch: the operands' type, rank, device and layout, the stream, the TI
lerp fractions on the device, and the launch counters. Nothing here
launches or builds anything."""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .common import ti_col_fracs

__all__ = ["frames", "on_card", "contiguous", "stream", "ti_fracs", "count", "tally_launches",
           "read_tally"]

_count_lock = threading.Lock()
_local = threading.local()


def frames(image, kernel: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``image`` as ``(b, h, w)`` frames of ``dtype`` (an ``(h, w)`` frame
    gains a leading axis), or ``TypeError`` / ``ValueError`` naming
    ``kernel``. A bf16 entry point takes ``dtype=torch.bfloat16`` and
    refuses float32 frames, and an fp32 one the other way round."""
    if not isinstance(image, torch.Tensor):
        raise TypeError(f"{kernel} takes a torch.Tensor, got {type(image).__name__}")
    if image.dtype != dtype:
        name = str(dtype).replace("torch.", "")
        raise TypeError(f"{kernel} takes {name} frames, got {image.dtype}")
    if image.dim() == 2:
        image = image[None]
    if image.dim() != 3 or min(image.shape) < 1:
        raise ValueError(f"{kernel} takes (h, w) or (b, h, w) frames, got {tuple(image.shape)}")
    return image


def on_card(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {t.device}")
    return True


def contiguous(t: torch.Tensor, what: str, kernel: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{kernel} needs contiguous {what}")


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the pointer ctypes passes: the
    raw pointer, without building a ``torch.cuda.Stream`` object (a launch
    of a few microseconds must not spend as long on the host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=64)
def ti_fracs(w: int, r: int, device: torch.device):
    """(yf, xf) TI lerp fractions as the JAX kernels compute them, on device."""
    xf = (np.arange(r) / r).astype(np.float32)
    return (
        torch.as_tensor(ti_col_fracs(w, r), device=device),
        torch.as_tensor(xf, device=device),
    )


def count(fn, attr: str) -> None:
    """Add one to the launch counter ``fn.attr`` (``bg_fused.launches``, ...)
    and to the calling thread's tally, if it has one, as one atomic step:
    the engines of several in-process workers launch from their own
    threads, and a read-modify-write of a counter is not atomic under the
    interpreter lock."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)
        tally = getattr(_local, "tally", None)
        if tally is not None:
            key = f"{fn.__name__}.{attr}"
            tally[key] = tally.get(key, 0) + 1


def tally_launches(tally) -> None:
    """Also count the calling thread's launches into the dict ``tally``
    (``{"bg_fused.temporal_launches": n, ...}``); ``None`` stops it."""
    _local.tally = tally


def read_tally(tally) -> dict:
    """A consistent copy of a tally that :func:`count` writes."""
    with _count_lock:
        return dict(tally)
