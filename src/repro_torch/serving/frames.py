"""Frame-denoise serving engine: synchronous micro-batched dispatch on one
device.

Clients submit frames one at a time; ``step()`` dispatches up to
``max_batch`` queued frames as one batch through the engine's
:class:`repro_torch.plan.BGPlan` (with the ``"fused"`` or ``"fused_streamed"``
backend on a CUDA device, one kernel launch per dispatch), as the JAX
package's engine does
on one device. ``flush()`` drains the queue in such batches, the last one
ragged. Results stay on the plan's device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import torch

from repro_torch.core.bilateral_grid import BGConfig

__all__ = ["FrameRequest", "FrameDenoiseEngine"]


@dataclasses.dataclass
class FrameRequest:
    uid: int
    frame: Any  # (h, w) grayscale [0, 255], numpy array or tensor
    result: Optional[torch.Tensor] = None


class FrameDenoiseEngine:
    """Micro-batching front for the bilateral-grid plan, single device.

    Pass ``plan=`` (it must quantize its output, and it names the device),
    or ``cfg=`` and optionally ``device=`` to build the ``"fused"`` plan
    (``stream_input=True``: the ``"fused_streamed"`` plan, as the JAX
    engine builds it). ``max_batch`` must be >= 1 (0 or negative is
    rejected, not clamped); it caps frames per dispatch. A bf16 plan
    (``precision="bf16"``) serves like any other: frames go to the card as
    float32 and the plan casts them to bf16 there.
    """

    def __init__(
        self,
        cfg: BGConfig | None = None,
        max_batch: int = 32,
        stream_input: bool = False,
        *,
        plan=None,
        device=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if plan is None:
            if cfg is None:
                raise TypeError("FrameDenoiseEngine needs cfg= or plan=")
            from repro_torch.plan import BGPlan

            backend = "fused_streamed" if stream_input else "fused"
            plan = BGPlan(cfg=cfg, backend=backend, device=device)
        elif device is not None or stream_input:
            raise ValueError(
                "pass device= and stream_input= with cfg=; a plan carries its "
                "own device and backend"
            )
        elif not plan.quantize_output:
            raise ValueError(
                "FrameDenoiseEngine serves quantized frames; build the plan "
                "with quantize_output=True"
            )
        self.plan = plan
        self.max_batch = max_batch
        self._queue: Deque[FrameRequest] = deque()

    @property
    def cfg(self) -> BGConfig:
        return self.plan.cfg

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def submit(self, req: FrameRequest) -> None:
        """Queue one frame; it is denoised at the next ``step``."""
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def step(self) -> List[FrameRequest]:
        """Dispatch up to ``max_batch`` queued frames as one batch and return
        the completed requests (empty when nothing is queued). The JAX
        package's ``force=`` exists for multi-device ragged tails; on one
        device every count divides evenly, so the port has none."""
        k = min(len(self._queue), self.max_batch)
        if k == 0:
            return []
        reqs = [self._queue.popleft() for _ in range(k)]
        dev = self.plan.device
        batch = torch.stack(
            [torch.as_tensor(r.frame, dtype=torch.float32, device=dev) for r in reqs]
        )
        out = self.plan(batch)
        for i, r in enumerate(reqs):
            r.result = out[i]
        return reqs

    def flush(self) -> List[FrameRequest]:
        """Drain the queue completely (forced ragged dispatches)."""
        done: List[FrameRequest] = []
        while self._queue:
            done.extend(self.step())
        return done
