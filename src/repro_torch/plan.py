"""Execution plans for the bilateral-grid pipeline (``BGPlan``), narrowed to
what the port runs so far.

A :class:`BGPlan` is one frozen, hashable record of every dispatch decision,
validated once at construction. Calling a plan runs its cached executable;
equal plans share one executable.

  backend           route
  ----------------  --------------------------------------------------------
  "reference"       whole-image GC -> GF -> TI per frame (``repro_torch.core``);
                    the numerical oracle. Temporal: the staged oracle
                    (``blurred_grid_batch`` -> EMA blend -> normalize -> slice)
  "fused"           the fused CUDA kernel B1 (``kernels/bg_fused.py``), grid
                    kept in shared memory; its plain version on the CPU.
                    Temporal: the same kernel with the in-kernel grid EMA (B2)
  "fused_streamed"  the streamed fused kernel B3 (``bg_fused(stream_input=
                    True)``): each frame read once through a ring of rows,
                    B1's output bit for bit; one launch per ``batch_tile``
  "staged"          the three staged kernels on the whole dispatch, grid in
                    HBM between them: GC (B4) -> GF (B5) -> normalize (a
                    torch expression) -> TI (B6), one launch of each

A temporal plan (``temporal=True``) is called as ``plan(frames, carry=,
alpha=)`` and returns ``(out, new_carry)``; the video packer derives the
temporal and per-frame variants of one base plan per pack
(:meth:`BGPlan.as_temporal`).

``precision="bf16"`` is the bf16 storage form of the JAX package's
``"reference"``, ``"fused"`` and ``"fused_streamed"`` routes, per frame and
temporal (``"staged"`` has none there either): the kernel routes cast the
frames to bf16 on the plan's device, run the bf16 entry points of B1, B2 and
B3 (the contract is in ``kernels/bg_fused.py``), upcast the output to
float32 before quantizing and keep the carry in bf16; the reference routes
round the frames (and store the temporal carry) in bf16 and compute in
fp32. The JAX package's ``"streaming"`` route and mesh sharding are valid
plans there and raise ``NotImplementedError`` here until they are ported. A
plan the JAX package rejects is rejected here with the same ``ValueError``.

The device is part of the plan: ``device=None`` means the CUDA card and
raises when there is none; ``device="cpu"`` runs the plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import (
    BGConfig,
    bilateral_grid_filter,
    quantize_intensity,
)
from repro_torch.kernels.common import PRECISIONS, precision_bytes, round_storage, storage_dtype

__all__ = ["BGPlan", "BACKENDS", "PRECISIONS", "PORTED_BACKENDS", "precision_bytes"]

# the JAX package's names, so its plans validate here the same way
BACKENDS = ("reference", "streaming", "staged", "fused", "fused_streamed")
_KERNEL_BACKENDS = ("staged", "fused", "fused_streamed")
_FUSED_BACKENDS = ("fused", "fused_streamed")
_TEMPORAL_BACKENDS = ("reference", "fused")
_BF16_BACKENDS = ("reference", "fused", "fused_streamed")
PORTED_BACKENDS = ("reference", "fused", "fused_streamed", "staged")


@dataclasses.dataclass(frozen=True)
class BGPlan:
    """One frozen, hashable record of every bilateral-grid dispatch decision.

    Fields:
      cfg:             the grid/window configuration (frozen ``BGConfig``).
      backend:         ``"reference"``, ``"fused"``, ``"fused_streamed"`` or
                       ``"staged"`` (module docstring).
      temporal:        the video grid-EMA form: called with ``carry=`` and
                       ``alpha=``, returns ``(out, new_carry)``.
      batch_tile:      frames per kernel launch on the fused backends
                       (``None``: the whole dispatch in one launch); frames
                       per pass of the plain version on the CPU. Results do
                       not depend on it. Normalized to ``None`` elsewhere.
      quantize_output: apply the paper's output rounding at the exit.
      precision:       storage dtype, ``"fp32"`` or ``"bf16"`` (the bf16
                       storage / fp32 accumulate form of ``"reference"``,
                       ``"fused"`` and ``"fused_streamed"``; module
                       docstring).
      device:          where the plan runs; ``None`` resolves to the CUDA
                       card (raising if there is none), ``"cpu"`` runs the
                       plain versions.
    """

    cfg: BGConfig
    backend: str = "fused"
    temporal: bool = False
    batch_tile: Optional[int] = None
    quantize_output: bool = True
    precision: str = "fp32"
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        # the JAX package's validation (repro/plan.py BGPlan.__post_init__)
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; expected one of "
                f"{PRECISIONS}"
            )
        if self.precision == "bf16" and self.backend not in _BF16_BACKENDS:
            raise ValueError(
                f"precision='bf16' is implemented by backends "
                f"{_BF16_BACKENDS}; backend {self.backend!r} has no "
                f"storage-precision contract"
            )
        bt = self.batch_tile
        if bt is not None:
            if isinstance(bt, bool) or not isinstance(bt, int):
                raise ValueError(
                    f"batch_tile must be a positive int or None, got "
                    f"{bt!r} ({type(bt).__name__})"
                )
            if bt < 1:
                raise ValueError(f"batch_tile must be >= 1, got {bt}")
            if self.backend not in _FUSED_BACKENDS:
                object.__setattr__(self, "batch_tile", None)
        if self.backend in _KERNEL_BACKENDS and self.cfg.normalize_mode != "paper":
            raise ValueError(
                "kernel backends implement the paper normalization mode "
                f"(got normalize_mode={self.cfg.normalize_mode!r})"
            )
        if self.temporal:
            if self.backend == "fused_streamed":
                raise ValueError(
                    "stream_input does not compose with a temporal carry; "
                    "use backend='fused'"
                )
            if self.backend not in _TEMPORAL_BACKENDS:
                raise ValueError(
                    f"temporal plans support backends {_TEMPORAL_BACKENDS}, "
                    f"got {self.backend!r}"
                )
        # valid in the JAX package, not ported yet
        if self.backend not in PORTED_BACKENDS:
            raise NotImplementedError(f"backend {self.backend!r} is not yet ported")
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------ utilities
    @property
    def storage_dtype(self) -> torch.dtype:
        """The dtype frames, scratch and the temporal carry are held in:
        ``torch.float32``, or ``torch.bfloat16`` for ``precision="bf16"``."""
        return storage_dtype(self.precision)

    @property
    def np_storage_dtype(self) -> np.dtype:
        """The numpy dtype of the snapshot side: float32 for both
        precisions. numpy has no bfloat16, so a bf16 carry leaves the card
        as float32 values that hold its bf16 values exactly
        (``MultiStreamPacker.export_carries``)."""
        return np.dtype(np.float32)

    def tile_for(self, n_frames: int) -> int:
        """Frames per kernel launch for an ``n_frames`` pack: the whole pack
        when ``batch_tile`` is ``None``, else ``batch_tile`` cut to the pack.
        The video packer asks the plan for it per pack."""
        n = max(1, int(n_frames))
        return n if self.batch_tile is None else min(self.batch_tile, n)

    def with_tile(self, batch_tile: int) -> "BGPlan":
        """This plan with ``batch_tile`` pinned (cached: per-pack hot path)."""
        if batch_tile == self.batch_tile:
            return self
        return _variant(self, "batch_tile", batch_tile)

    def with_options(self, **changes) -> "BGPlan":
        """``dataclasses.replace`` with plan validation re-run."""
        return dataclasses.replace(self, **changes)

    def as_temporal(self, temporal: bool = True) -> "BGPlan":
        """The temporal / per-frame variant of this plan (cached: the video
        packer derives one per pack)."""
        if self.temporal == temporal:
            return self
        return _variant(self, "temporal", temporal)

    # -------------------------------------------------------- serialization
    def to_json(self) -> dict:
        """The JAX package's version-1 payload (``repro.plan.BGPlan.to_json``).
        The device is not part of it: a loading host binds its own."""
        return {
            "version": 1,
            "cfg": dataclasses.asdict(self.cfg),
            "backend": self.backend,
            "temporal": self.temporal,
            "batch_tile": self.batch_tile,
            "mesh_size": 1,
            "quantize_output": self.quantize_output,
            "interpret": None,
            "precision": self.precision,
        }

    @classmethod
    def from_json(cls, data: dict, *, device=None) -> "BGPlan":
        """Rebuild a plan from a version-1 payload, written by either package,
        bound to ``device``. ``interpret`` is a Pallas setting and is
        ignored; fields this port does not run yet raise
        ``NotImplementedError``."""
        if int(data.get("version", 1)) != 1:
            raise ValueError(
                f"unknown BGPlan serialization version {data.get('version')!r}"
            )
        if int(data.get("mesh_size", 1)) > 1:
            raise NotImplementedError("mesh plans are not yet ported")
        return cls(
            cfg=BGConfig(**data["cfg"]),
            backend=data["backend"],
            temporal=bool(data.get("temporal", False)),
            batch_tile=data.get("batch_tile"),
            quantize_output=bool(data.get("quantize_output", True)),
            precision=data.get("precision", "fp32"),
            device=device,
        )

    def describe(self) -> str:
        """One-line dispatch summary for logs."""
        return (
            f"backend={self.backend} temporal={self.temporal} "
            f"bt={self.batch_tile} prec={self.precision} device={self.device}"
        )

    # ------------------------------------------------------------- dispatch
    def executable(self):
        """The plan's callable (one per equal plan): ``fn(frames) -> out``,
        or for a temporal plan ``fn(frames, carry, alpha) -> (out,
        new_carry)``."""
        return _plan_executable(self)

    def __call__(self, frames, carry=None, alpha=None):
        """Denoise a (h, w) frame, a (b, h, w) batch or a (b, h, w, c) color
        batch (channels are folded into the batch: each gets its own grid).
        Frames (numpy or tensor) are moved to the plan's device as float32;
        the result stays there, float32.

        A temporal plan takes (h, w) or (n, h, w) frames with ``carry`` (the
        ``(n, gx, gy, gz, 2)`` carries, moved to the device in the storage
        type, as the JAX package's ``carry.astype(sdt)``) and ``alpha`` and
        returns ``(out, new_carry)``, the carry in the storage type. A host alpha (scalar, list or numpy) is broadcast to
        ``(n,)`` and range-checked here, once; a tensor alpha is trusted, as
        checking a device tensor would wait for the card."""
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        if self.temporal:
            if carry is None or alpha is None:
                raise ValueError("temporal plan dispatch needs both carry= and alpha=")
            if not isinstance(carry, torch.Tensor):
                carry = torch.as_tensor(np.asarray(carry, np.float32))
            carry = carry.to(device=self.device, dtype=self.storage_dtype)
            squeeze = frames.dim() == 2
            if squeeze:
                frames, carry = frames[None], carry[None]
            if frames.dim() != 3:
                raise ValueError(
                    f"temporal plans take (h, w) or (n, h, w) frames, got "
                    f"{tuple(frames.shape)}"
                )
            n = frames.shape[0]
            if isinstance(alpha, torch.Tensor):
                alpha = alpha.to(device=self.device, dtype=torch.float32)
                if alpha.dim() == 0:
                    alpha = alpha.expand(n)
            else:
                alpha_np = np.broadcast_to(np.asarray(alpha, np.float32), (n,))
                if (alpha_np < 0.0).any() or (alpha_np >= 1.0).any():
                    raise ValueError(f"temporal alpha must be in [0, 1), got {alpha}")
                alpha = torch.as_tensor(alpha_np.copy(), device=self.device)
            out, new_carry = self.executable()(
                frames.contiguous(), carry.contiguous(), alpha.contiguous()
            )
            return (out[0], new_carry[0]) if squeeze else (out, new_carry)
        if carry is not None or alpha is not None:
            raise ValueError("carry/alpha require a temporal plan (BGPlan(temporal=True))")
        if frames.dim() == 4:
            b, h, w, c = frames.shape
            folded = frames.movedim(-1, 1).reshape(b * c, h, w).contiguous()
            out = self.executable()(folded)
            return out.reshape(b, c, h, w).movedim(1, -1)
        if frames.dim() not in (2, 3):
            raise ValueError(
                f"expected (h, w), (b, h, w) or (b, h, w, c) frames, got "
                f"{tuple(frames.shape)}"
            )
        return self.executable()(frames.contiguous())


@functools.lru_cache(maxsize=256)
def _variant(plan: BGPlan, field: str, value) -> BGPlan:
    """``plan`` with one field changed, validated once per distinct value."""
    return dataclasses.replace(plan, **{field: value})


@functools.lru_cache(maxsize=256)
def _plan_executable(plan: BGPlan):
    """ONE callable per plan: the compute route plus output quantization.
    Under ``precision="fp32"`` every storage cast below is the identity."""
    cfg = plan.cfg
    quant = plan.quantize_output
    prec = plan.precision
    sdt = plan.storage_dtype

    def _maybe_quantize(out):
        out = out.to(torch.float32)  # the kernels' bf16 output, upcast
        return quantize_intensity(out, cfg) if quant else out

    if plan.temporal and plan.backend == "reference":
        # the staged oracle: the grid is visible between GF and TI; under
        # bf16 it rounds the frames, blends in fp32 and stores the carry in
        # bf16 (the JAX package's route)
        from repro_torch.core.bilateral_grid import grid_normalize, grid_slice
        from repro_torch.video.temporal import blurred_grid_batch

        def fn(frames, carry, alpha):
            frames = round_storage(frames, prec)
            a = alpha.reshape(-1, 1, 1, 1, 1)
            new_carry = (1.0 - a) * blurred_grid_batch(frames, cfg) + a * carry.to(torch.float32)
            grid_f = grid_normalize(new_carry)
            out = torch.stack([grid_slice(g, f, cfg) for g, f in zip(grid_f, frames)])
            return _maybe_quantize(out), new_carry.to(sdt)

        return fn

    if plan.temporal:
        from repro_torch.kernels.bg_fused import bg_fused

        def fn(frames, carry, alpha):
            out, new_carry = bg_fused(
                frames.to(sdt), cfg, batch_tile=plan.batch_tile, carry=carry, alpha=alpha,
                precision=prec,
            )
            return _maybe_quantize(out), new_carry

        return fn

    if plan.backend == "reference":

        def single(im):
            return bilateral_grid_filter(im, cfg, quantize_output=quant)

        def fn(frames):
            frames = round_storage(frames, prec)  # the frames the kernel would hold
            if frames.dim() == 3:
                return torch.stack([single(f) for f in frames])
            return single(frames)

        return fn

    if plan.backend == "staged":
        from repro_torch.kernels.ops import _staged_single

        def fn(frames):
            return _maybe_quantize(_staged_single(frames, cfg))

        return fn

    from repro_torch.kernels.bg_fused import bg_fused

    stream_input = plan.backend == "fused_streamed"

    def fn(frames):
        return _maybe_quantize(
            bg_fused(frames.to(sdt), cfg, batch_tile=plan.batch_tile, stream_input=stream_input,
                     precision=prec)
        )

    return fn
