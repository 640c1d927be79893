"""Execution plans for the bilateral-grid pipeline (``BGPlan``), narrowed to
what the port runs so far.

A :class:`BGPlan` is one frozen, hashable record of every dispatch decision,
validated once at construction. Calling a plan runs its cached executable;
equal plans share one executable.

  backend        route
  -------------  -----------------------------------------------------------
  "reference"    whole-image GC -> GF -> TI per frame (``repro_torch.core``);
                 the numerical oracle
  "fused"        the fused CUDA kernel (``kernels/bg_fused.py``), grid kept
                 in shared memory; its plain version on the CPU

The JAX package's other routes ("streaming", "staged", "fused_streamed"),
temporal plans, ``precision="bf16"`` and mesh sharding are valid plans there
and raise ``NotImplementedError`` here until they are ported. A plan the
JAX package rejects is rejected here with the same ``ValueError``.

The device is part of the plan: ``device=None`` means the CUDA card and
raises when there is none; ``device="cpu"`` runs the plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import (
    BGConfig,
    bilateral_grid_filter,
    quantize_intensity,
)

__all__ = ["BGPlan", "BACKENDS", "PRECISIONS", "PORTED_BACKENDS"]

# the JAX package's names, so its plans validate here the same way
BACKENDS = ("reference", "streaming", "staged", "fused", "fused_streamed")
_KERNEL_BACKENDS = ("staged", "fused", "fused_streamed")
_FUSED_BACKENDS = ("fused", "fused_streamed")
_TEMPORAL_BACKENDS = ("reference", "fused")
PRECISIONS = ("fp32", "bf16")
_BF16_BACKENDS = ("reference", "fused", "fused_streamed")
PORTED_BACKENDS = ("reference", "fused")


@dataclasses.dataclass(frozen=True)
class BGPlan:
    """One frozen, hashable record of every bilateral-grid dispatch decision.

    Fields:
      cfg:             the grid/window configuration (frozen ``BGConfig``).
      backend:         ``"reference"`` or ``"fused"`` (module docstring).
      temporal:        video grid-EMA form; not yet ported.
      batch_tile:      frames per kernel launch on the ``"fused"`` backend
                       (``None``: the whole dispatch in one launch); frames
                       per pass of the plain version on the CPU. Results do
                       not depend on it. Normalized to ``None`` elsewhere.
      quantize_output: apply the paper's output rounding at the exit.
      precision:       storage dtype; only ``"fp32"`` is ported.
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
        if self.temporal:
            raise NotImplementedError("temporal plans are not yet ported")
        if self.precision != "fp32":
            raise NotImplementedError(
                f"precision={self.precision!r} is not yet ported"
            )
        object.__setattr__(self, "device", resolve_device(self.device))

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
            f"backend={self.backend} bt={self.batch_tile} "
            f"prec={self.precision} device={self.device}"
        )

    # ------------------------------------------------------------- dispatch
    def executable(self):
        """The plan's callable ``fn(frames) -> out`` (one per equal plan)."""
        return _plan_executable(self)

    def __call__(self, frames):
        """Denoise a (h, w) frame, a (b, h, w) batch or a (b, h, w, c) color
        batch (channels are folded into the batch: each gets its own grid).
        Frames (numpy or tensor) are moved to the plan's device as float32;
        the result stays there."""
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
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
def _plan_executable(plan: BGPlan):
    """ONE callable per plan: the compute route plus output quantization."""
    cfg = plan.cfg
    quant = plan.quantize_output

    if plan.backend == "reference":

        def single(im):
            return bilateral_grid_filter(im, cfg, quantize_output=quant)

        def fn(frames):
            if frames.dim() == 3:
                return torch.stack([single(f) for f in frames])
            return single(frames)

        return fn

    from repro_torch.kernels.bg_fused import bg_fused

    def fn(frames):
        out = bg_fused(frames, cfg, batch_tile=plan.batch_tile)
        return quantize_intensity(out, cfg) if quant else out

    return fn
