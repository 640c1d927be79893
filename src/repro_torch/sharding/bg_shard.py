"""Batch-axis device sharding for the bilateral-grid service path: the port
of ``repro/sharding/bg_shard.py``.

Frames are independent, so the GPU analogue of the paper's "add more
pipeline stages" is pure data parallelism: a 1-D ``batch`` mesh of torch
devices where each device runs the whole fused GC -> GF -> TI kernel on its
slice of the frame batch. The same holds for the temporal video path
(:func:`bg_temporal_sharded`): the per-stream grid carry and alpha rows are
split with their stream's frame, so each device advances its streams' EMAs
and no data crosses between shards. A mesh dispatch
(``repro_torch.plan._mesh_call``):

  1. zero-pads the leading axis up to a multiple of the device count
     (:func:`_row_pad`; only the last shards see padding, added on their
     own device by :func:`_pad_rows`);
  2. moves each equal chunk to its device and runs the single-device route
     there: on a card the same kernel wrappers, each launch on that
     device's current stream;
  3. gathers the shards' real rows onto the mesh's first device, in order;
  4. so the padding is dropped, and quantization (elementwise) runs once on
     the gathered output.

There are no collectives, and no new kernel: each shard is the kernel the
single-device plan launches. A shard's frames are independent of the other
shards', so the sharded output equals the single-device output on the same
batch bit for bit, the temporal carry too (the port's kernels give each
frame the same bits whatever their launch geometry). The gather is a
cross-device copy that PyTorch orders after the source device's work and
before anything later on the first device's current stream, so an event
recorded there after a dispatch covers every shard.

``BatchMesh`` carries only the surface of ``jax.sharding.Mesh`` that the
plan layer reads: ``devices``, ``axis_names == ("batch",)`` and ``size``.
:func:`batch_mesh` gives the first n distinct CUDA devices.

Divergence from the JAX package (beside the image core's D1-D4): an
explicit ``BatchMesh`` may name one device more than once. It is the port's
stand-in for JAX's forced host-device count
(``--xla_force_host_platform_device_count``): a CPU mesh of n ``"cpu"``
handles drives the pad -> split -> dispatch -> gather -> trim path in the
tests, and a mesh naming one card twice drives it through the kernels on a
one-card host. Shards of a repeated device run one after the other there,
so such a mesh shows the path, never a speed-up.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import BGConfig

__all__ = [
    "BATCH_AXIS",
    "BatchMesh",
    "batch_mesh",
    "shard_batch_call",
    "bg_denoise_sharded",
    "bg_temporal_sharded",
]

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D data-parallel mesh: the torch devices the batch axis is split
    over, in order. Frozen and hashable (plans hold it and are cache keys).

    ``devices`` takes anything :func:`repro_torch._device.resolve_device`
    takes (``"cpu"``, ``"cuda:1"``, a ``torch.device``); all must be of one
    type. A device may repeat (module docstring)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (BATCH_AXIS,)

    def __post_init__(self):
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a BatchMesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a BatchMesh holds devices of one type, got {devices}")
        if tuple(self.axis_names) != (BATCH_AXIS,):
            raise ValueError(
                f"BGPlan meshes are 1-D batch meshes, got axes {tuple(self.axis_names)!r}"
            )
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", (BATCH_AXIS,))

    @property
    def size(self) -> int:
        return len(self.devices)


def batch_mesh(n_devices: Optional[int] = None) -> BatchMesh:
    """1-D data-parallel mesh over the first ``n_devices`` CUDA devices
    (all of them by default); ``ValueError`` outside ``[1, count]``."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n} not in [1, {count}]")
    return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)))


def _service_mesh(mesh: Optional[BatchMesh], device=None) -> Optional[BatchMesh]:
    """The service entry points' mesh default: an auto-mesh over every card
    when the caller wants the card (``device`` ``None`` or ``"cuda"``
    without an index) and more than one is visible; else ``mesh`` as given
    (``None``, or a size-1 mesh, which ``BGPlan`` degrades to the plain
    single-device call)."""
    if mesh is not None:
        return mesh
    dev = None if device is None else torch.device(device)
    wants_the_card = dev is None or (dev.type == "cuda" and dev.index is None)
    if wants_the_card and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return batch_mesh()
    return None


def _row_pad(nd: int, n: int) -> int:
    """Zero rows needed to bring a leading axis of ``n`` up to a device
    multiple (the shared ragged-batch rule: pad before the split, trim
    after)."""
    return -(-n // nd) * nd - n


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` zero rows appended on its leading axis, on its
    device and in its dtype (``t`` itself when ``pad`` is 0)."""
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _on(device: torch.device):
    """Make ``device`` current for a shard's work (its allocations and its
    current stream); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_batch_call(fn, images, mesh: BatchMesh) -> torch.Tensor:
    """Run per-frame-independent ``fn`` with the leading axis of ``images``
    split over ``mesh``: ``fn`` maps ``(b_shard, ...) -> (b_shard, ...)``
    on its shard's device; ragged batches are zero-padded to a device
    multiple and trimmed from the result, gathered on the mesh's first
    device. On a serving path prefer a mesh-carrying
    ``repro_torch.plan.BGPlan``."""
    from repro_torch.plan import _mesh_call

    return _mesh_call(fn, mesh, n_in=1, n_out=1)(torch.as_tensor(images))


def bg_denoise_sharded(
    images,
    cfg: BGConfig | None = None,
    mesh: Optional[BatchMesh] = None,
    *,
    batch_tile: Optional[int] = None,
    stream_input: bool = False,
    quantize_output: bool = False,
    plan=None,
    device=None,
) -> torch.Tensor:
    """Data-parallel fused BG denoise, the multi-device service entry point:
    (b, h, w) or (h, w) -> float32 on the mesh's first device, equal to the
    single-device ``bg_fused`` call bit for bit for every batch and mesh
    shape. ``mesh=None`` builds a mesh over every card when the caller
    wants the card (``device`` ``None``) and more than one is visible; one
    card, or a size-1 mesh, is the plain single-device call. Batches smaller
    than the mesh are padded (idle shards denoise zero frames that are
    dropped). ``quantize_output=True`` adds the paper's output rounding.
    Preferred form: a mesh-carrying ``repro_torch.plan.BGPlan`` via
    ``plan=``."""
    from repro_torch.plan import BGPlan

    if plan is None:
        if cfg is None:
            raise TypeError("bg_denoise_sharded needs cfg= or plan=")
        plan = BGPlan(
            cfg=cfg,
            backend="fused_streamed" if stream_input else "fused",
            batch_tile=batch_tile,
            quantize_output=quantize_output,
            device=device,
            mesh=_service_mesh(mesh, device),
        )
    return plan(images)


def bg_temporal_sharded(
    frames,
    carry,
    alpha,
    cfg: BGConfig | None = None,
    mesh: Optional[BatchMesh] = None,
    *,
    batch_tile: Optional[int] = None,
    quantize_output: bool = False,
    plan=None,
    device=None,
):
    """Data-parallel temporal fused BG denoise, the video warm-path entry:
    ``frames`` the ``(n, h, w)`` one-frame-per-stream pack, ``carry`` the
    stacked ``(n, gx, gy, gz, 2)`` carries, ``alpha`` the length-n blend
    weights. Returns ``(out, new_carry)`` on the mesh's first device: the
    stream axis is split like the frame axis (carry and alpha rows travel
    with their stream's shard), ragged packs are padded with zero frames,
    zero carries and zero alphas that are dropped after, and both results
    equal the single-device call bit for bit. ``mesh=None`` auto-meshes as
    :func:`bg_denoise_sharded` does. Preferred form: a temporal
    ``repro_torch.plan.BGPlan`` via ``plan=``."""
    from repro_torch.plan import BGPlan

    if plan is None:
        if cfg is None:
            raise TypeError("bg_temporal_sharded needs cfg= or plan=")
        plan = BGPlan(
            cfg=cfg,
            backend="fused",
            temporal=True,
            batch_tile=batch_tile,
            quantize_output=quantize_output,
            device=device,
            mesh=_service_mesh(mesh, device),
        )
    return plan(frames, carry=carry, alpha=alpha)
