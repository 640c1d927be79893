"""Frame-denoise serving engine: mesh-divisible micro-batched dispatch.

Clients submit frames one at a time; ``step()`` dispatches a micro-batch
through the engine's :class:`repro_torch.plan.BGPlan` (with the ``"fused"``
or ``"fused_streamed"`` backend on a CUDA device, one kernel launch per
dispatch and device) when a count divisible by the device count of the
plan's batch mesh is queued, so every shard is equal-sized and no data
crosses devices (``repro_torch.sharding``). ``step(force=True)`` /
``flush()`` dispatch the ragged tail too; the mesh pads it with zero frames.
On one device every count divides. Results are on the plan's device (the
mesh's first).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import torch

from repro_torch import tracing
from repro_torch.core.bilateral_grid import BGConfig

__all__ = ["FrameRequest", "FrameDenoiseEngine"]


@dataclasses.dataclass
class FrameRequest:
    uid: int
    frame: Any  # (h, w) grayscale [0, 255], numpy array or tensor
    result: Optional[torch.Tensor] = None


class FrameDenoiseEngine:
    """Micro-batching front for the bilateral-grid plan, sharded over the
    plan's batch mesh.

    Pass ``plan=`` (it must quantize its output, and it names the device and
    mesh), or ``cfg=`` and optionally ``device=`` and ``mesh=`` to build the
    ``"fused"`` plan (``stream_input=True``: the ``"fused_streamed"`` plan,
    as the JAX engine builds it); ``mesh=None`` meshes over every card when
    the caller wants the card and more than one is visible (one card: the
    plain plan). ``max_batch`` must be >= 1 (0 or negative is rejected, not
    clamped); it caps frames per dispatch and is rounded down to a multiple
    of the device count ``n_devices``, but never below it (the smallest
    batch that shards evenly). A bf16 plan (``precision="bf16"``) serves
    like any other: frames go to the card as float32 and the plan casts
    them to bf16 there.
    """

    def __init__(
        self,
        cfg: BGConfig | None = None,
        max_batch: int = 32,
        stream_input: bool = False,
        *,
        plan=None,
        device=None,
        mesh=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if plan is None:
            if cfg is None:
                raise TypeError("FrameDenoiseEngine needs cfg= or plan=")
            from repro_torch.plan import BGPlan
            from repro_torch.sharding.bg_shard import _service_mesh

            backend = "fused_streamed" if stream_input else "fused"
            plan = BGPlan(cfg=cfg, backend=backend, device=device, mesh=_service_mesh(mesh, device))
        elif device is not None or stream_input or mesh is not None:
            raise ValueError(
                "pass device=, mesh= and stream_input= with cfg=; a plan carries "
                "its own device, mesh and backend"
            )
        elif not plan.quantize_output:
            raise ValueError(
                "FrameDenoiseEngine serves quantized frames; build the plan "
                "with quantize_output=True"
            )
        self.plan = plan
        self.n_devices = plan.mesh_size
        self.max_batch = max(1, max_batch // self.n_devices) * self.n_devices
        self._queue: Deque[FrameRequest] = deque()

    @property
    def cfg(self) -> BGConfig:
        return self.plan.cfg

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def mesh(self):
        return self.plan.mesh

    def submit(self, req: FrameRequest) -> None:
        """Queue one frame; it is denoised at the next ``step``."""
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def step(self, force: bool = False) -> List[FrameRequest]:
        """Dispatch one micro-batch if a mesh-divisible count is queued (up to
        ``max_batch``) and return the completed requests (empty while still
        accumulating). ``force=True`` dispatches a ragged tail too; the
        mesh pads it with zero frames. The frames stack on the plan's device,
        or for a mesh plan where they are (host frames on the host), and
        each shard moves to its own device."""
        n = len(self._queue)
        k = min((n // self.n_devices) * self.n_devices, self.max_batch)
        if k == 0 and force and n:
            k = min(n, self.max_batch)
        if k == 0:
            return []
        with tracing.span("engine.step", k):
            reqs = [self._queue.popleft() for _ in range(k)]
            dev = self.plan.input_device
            batch = torch.stack(tracing.as_frames([r.frame for r in reqs], dev, "engine.stack"))
            out = self.plan(batch)
            for i, r in enumerate(reqs):
                r.result = out[i]
            return reqs

    def flush(self) -> List[FrameRequest]:
        """Drain the queue completely (forced ragged dispatches)."""
        done: List[FrameRequest] = []
        while self._queue:
            done.extend(self.step(force=True))
        return done
