"""Admission validation and post-dispatch finite-guards: the port of
``repro/reliability/guards.py``.

One NaN pixel splatted into the grid blurs across its neighbourhood, the
carry blend ``G_t = (1-a)B_t + a G_{t-1}`` folds it into the stream's
history, and every later frame of that stream slices against a poisoned
grid. Two cheap layers stop that:

  * **Admission** (:func:`validate_frame`): host-side shape, dtype and
    finite checks at ``submit``, before a frame can touch the queue.
  * **Post-dispatch guards** (:func:`finite_rows`, :func:`carry_ok_rows`):
    per-row ``torch.isfinite`` reductions launched on the device with the
    dispatch and read at completion. A failing output row fails its request
    with ``NonFiniteOutput``; a failing carry row quarantines its stream
    (``MultiStreamPacker.quarantine`` resets it to cold).

:class:`DispatchGuard` travels with each in-flight batch from dispatch to
completion: the flag tensors plus the stream-id order that maps flag rows
back to requests.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Optional, Tuple

import numpy as np
import torch

from .errors import AdmissionError

__all__ = [
    "DEFAULT_CARRY_LIMIT",
    "DispatchGuard",
    "validate_frame",
    "finite_rows",
    "carry_ok_rows",
]

# Out-of-range bound for temporal carries: counts are bounded by pixels per
# cell over the EMA's 1/(1-a) window, sums by 255x that; a full-HD stream at
# a = 0.99 stays under ~5e9, so 1e12 flags only runaway values.
DEFAULT_CARRY_LIMIT = 1e12


@dataclasses.dataclass
class DispatchGuard:
    """Per-batch guard state: flag tensors launched with the batch.

    ``out_ok`` is an ``(n,)`` bool tensor (True = row finite), ordered by
    ``order`` (stream ids, video mode) or positionally (``order=None``).
    ``carry_ok`` covers the ``carry_sids`` streams whose temporal carry
    advanced this pack. ``None`` fields mean "nothing to check".
    """

    out_ok: Optional[torch.Tensor] = None
    order: Optional[Tuple[Hashable, ...]] = None
    carry_sids: Tuple[Hashable, ...] = ()
    carry_ok: Optional[torch.Tensor] = None


def validate_frame(frame, *, stream_id: Hashable = None) -> np.ndarray:
    """Admission check for one submitted frame: 2-D, real numeric, finite.

    Returns the frame as a numpy array (what the dispatch thread stacks);
    raises :class:`AdmissionError` (a ``ValueError``) otherwise. Host-side.
    """
    try:
        arr = np.asarray(frame)
    except Exception as exc:
        raise AdmissionError(
            f"not convertible to an array: {exc}", stream_id=stream_id
        ) from exc
    if arr.ndim != 2:
        raise AdmissionError(
            f"expected a 2-D (h, w) frame, got shape {arr.shape}",
            stream_id=stream_id,
        )
    if arr.size == 0:
        raise AdmissionError("empty frame", stream_id=stream_id)
    if not np.issubdtype(arr.dtype, np.number) or np.issubdtype(
        arr.dtype, np.complexfloating
    ):
        raise AdmissionError(
            f"expected a real numeric dtype, got {arr.dtype}", stream_id=stream_id
        )
    if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
        raise AdmissionError(
            "frame contains non-finite values (NaN/Inf)", stream_id=stream_id
        )
    return arr


def finite_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row finite flags, ``(n, ...) -> (n,)`` bool, on ``x``'s device;
    launched with the dispatch, read at completion."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def carry_ok_rows(carry: torch.Tensor, limit: float = DEFAULT_CARRY_LIMIT) -> torch.Tensor:
    """Per-stream carry health flags: finite and ``|carry| < limit``. A
    False row means that stream's carry would poison its later frames."""
    flat = carry.reshape(carry.shape[0], -1)
    return (torch.isfinite(flat) & (flat.abs() < limit)).all(dim=1)
