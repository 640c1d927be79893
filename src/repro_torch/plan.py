"""Execution plans for the bilateral-grid pipeline (``BGPlan``), their
selection (``plan_for`` on an H100 cost model and the measured-plan cache)
and the fallback ladder the guarded engines dispatch down.

A :class:`BGPlan` is one frozen, hashable record of every dispatch decision,
validated once at construction. Calling a plan runs its cached executable;
equal plans share one executable.

  backend           route
  ----------------  --------------------------------------------------------
  "reference"       whole-image GC -> GF -> TI per frame (``repro_torch.core``);
                    the numerical oracle. Temporal: the staged oracle
                    (``blurred_grid_batch`` -> EMA blend -> normalize -> slice)
  "streaming"       the paper's stripe pipeline (``core/streaming.py``): a loop
                    over stripes of r rows carrying three raw and two blurred
                    grid planes, the whole batch per step. Plain tensor
                    operations on the plan's device, as ``jnp`` in the JAX
                    package (no kernel there either); fp32, not temporal
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
fp32, with or without a mesh. A plan the JAX package rejects is rejected
here with the same ``ValueError``.

The device is part of the plan: ``device=None`` means the CUDA card and
raises when there is none; ``device="cpu"`` runs the plain versions.

``mesh`` (a :class:`repro_torch.sharding.BatchMesh`) splits the frame or
stream batch axis of the ``"streaming"``, ``"fused"`` and
``"fused_streamed"`` routes over its devices: pure data parallelism, no
collectives (:func:`_mesh_call`, ``repro_torch.sharding.bg_shard``). A
mesh plan's ``device`` is the mesh's first device, where its outputs are
gathered; its inputs stay where the caller has them and each shard moves
to its own device. A size-1 mesh degrades to the plain call on its device.

Plan selection (:func:`plan_for`)
---------------------------------
``plan_for`` resolves the free decisions (``"fused"`` or
``"fused_streamed"``, ``batch_tile``, and with ``precision="auto"`` the
storage type) in the JAX package's order: pinned arguments first (provenance
``"explicit"``), then the measured-plan cache (:mod:`repro_torch.plan_cache`,
``"cache"``), then the cost model below (``"model"``). A plan built directly
has provenance ``"default"``. It never picks ``"staged"``, ``"streaming"``
or ``"reference"``; they are reachable when pinned.

The batch tile rule (:func:`auto_batch_tile`). On the TPU the tile was
bounded by a per-step VMEM budget. On the H100 a block's shared memory does
not grow with the batch: ``launch_geometry`` and ``stream_geometry`` cut
band, rows and column tile to fit, and raise ``ValueError`` (naming the
bytes) only when one stripe of one cell does not fit. So the largest legal
tile is the whole pack, capped at ``MAX_AUTO_TILE`` (64, the JAX package's
cap, kept as the top of the candidate ladder, not as a memory rule), and the
rule raises where the geometry raises.

The H100 cost model (:func:`plan_cost_breakdown`). Per dispatch of ``b``
frames of ``h x w``, on one H100 SXM (``HBM_BYTES_PER_S``,
``FP32_FLOPS_PER_S``):

  compute_s   the kernels' operations (:func:`fused_work`, the counts
              ``chip_smoke.py`` takes its bounds from) over the fp32 rate.
  memory_s    the bytes the dispatch moves over the HBM rate: the kernels'
              inputs read once and outputs written once (:func:`fused_work`),
              plus the frame's second read in B1 and B2 (GC and TI each read
              it; B3 reads it once), plus under bf16 the plan's two casts
              (frames to bf16 before the kernel, the output back to float32).
  overhead_s  ``FRAME_OVERHEAD_S`` per frame (the quantization pass, and
              what a kernel spends per frame above its bytes),
              ``LAUNCH_OVERHEAD_S`` per kernel launch (host work per wrapper
              call, and a small launch filling the card poorly),
              ``STREAM_LAUNCH_OVERHEAD_S`` more per B3 launch. There is no
              term per dispatch: fitted beside these, it came out 0.

``total_s`` (the sum) ranks candidates; ``bound_s`` is the roofline
``max(compute, memory)``. ``steps`` counts kernel launches. The overhead
constants are fitted on the card by least squares over the measured
candidates of ``chip_smoke.py``'s ``plan_sweep`` phase (each constant names
its card and power limit). :func:`plan_cost_measured` times a plan's
dispatch on its device: the sweep's measurement.

Guarded dispatch: :meth:`BGPlan.fallback_ladder` gives the rungs
``repro_torch.reliability.GuardedDispatch`` walks, and
:func:`set_dispatch_hook` installs a host-side hook run at the top of every
``BGPlan.__call__`` (fault injection, tracing).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import (
    BGConfig,
    bilateral_grid_filter,
    grid_shape,
    quantize_intensity,
)
from repro_torch.kernels.common import PRECISIONS, precision_bytes, round_storage, storage_dtype
from repro_torch.sharding.bg_shard import BatchMesh

__all__ = [
    "BGPlan",
    "BACKENDS",
    "PRECISIONS",
    "precision_bytes",
    "plan_for",
    "plan_cost",
    "plan_cost_breakdown",
    "plan_cost_measured",
    "candidate_plans",
    "auto_batch_tile",
    "fused_work",
    "staged_work",
    "set_dispatch_hook",
    "MAX_AUTO_TILE",
    "HBM_BYTES_PER_S",
    "FP32_FLOPS_PER_S",
    "FRAME_OVERHEAD_S",
    "LAUNCH_OVERHEAD_S",
    "STREAM_LAUNCH_OVERHEAD_S",
]

# the JAX package's names, so its plans validate here the same way
BACKENDS = ("reference", "streaming", "staged", "fused", "fused_streamed")
_KERNEL_BACKENDS = ("staged", "fused", "fused_streamed")
_FUSED_BACKENDS = ("fused", "fused_streamed")
_MESH_BACKENDS = ("streaming", "fused", "fused_streamed")
_TEMPORAL_BACKENDS = ("reference", "fused")
_BF16_BACKENDS = ("reference", "fused", "fused_streamed")

# ------------------------------------------------------- the H100 cost model
# One H100 SXM: HBM rate and fp32 rate outside the tensor cores (data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Streaming multiprocessors of the H100 SXM; only the band split of the
# geometry rules reads it (auto_batch_tile's check does not depend on it).
H100_SMS = 132
# Top of the batch-tile ladder (the JAX package's MAX_AUTO_TILE).
MAX_AUTO_TILE = 64
# Overhead terms (module docstring), fitted by least squares (no intercept,
# clipped at 0) over the 54 candidates of the five fitting workloads of
# chip_smoke.py's plan_sweep phase at 1080x1920 on an NVIDIA H100 80GB HBM3,
# 700.00 W (residual 34.90 us rms). Not fitted to its three held-out
# workloads, where the phase reads the model's regret.
FRAME_OVERHEAD_S = 36.15e-6  # H100 80GB HBM3, 700.00 W
LAUNCH_OVERHEAD_S = 19.72e-6  # H100 80GB HBM3, 700.00 W
STREAM_LAUNCH_OVERHEAD_S = 4.44e-6  # H100 80GB HBM3, 700.00 W
# The batch-tile candidates the model ranks: powers of two below the cap,
# plus the cap itself.
_TILE_LADDER = (1, 2, 4, 8, 16, 32, 64)


def fused_work(b: int, h: int, w: int, cfg: BGConfig, esize: int = 4,
               temporal: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of the fused filter (B1, B3; ``temporal``: B2) on
    ``b`` frames of ``esize``-byte pixels (4 fp32, 2 bf16), each input read
    once and each output written once (the TI fractions are fp32), against
    the operations of separable GC / GF / TI: 32 per pixel (5 in GC, 27 in
    TI) and 33 per grid cell (GF and normalization). The temporal kernel
    adds the carry read and written (2 x esize bytes per cell and channel),
    the fp32 alpha, and 6 operations per cell for the blend of both
    channels. ``chip_smoke.py`` takes its bounds from these counts."""
    gx, gy, gz = grid_shape(h, w, cfg)
    cells = gx * gy * gz
    nbytes = b * h * w * esize * 2 + (w + cfg.r) * 4
    flops = b * (32 * h * w + 33 * cells)
    if temporal:
        nbytes += b * (2 * cells * 2 * esize + 4)
        flops += b * 6 * cells
    return nbytes, flops


def staged_work(b: int, h: int, w: int, cfg: BGConfig) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} of the staged kernels on ``b`` frames,
    each input read once and each output written once: B4 reads the frames
    and writes the (count, sum) grid (5 operations per pixel); B5 reads and
    writes that grid (15 per value: 3 taps along 3 axes); B6 reads the
    frames and the scalar grid and writes the frames (27 per pixel)."""
    gx, gy, gz = grid_shape(h, w, cfg)
    img, cells = h * w * 4, gx * gy * gz
    return {"B4": (b * (img + cells * 8), b * 5 * h * w),
            "B5": (b * 2 * cells * 8, b * 15 * cells * 2),
            "B6": (b * (2 * img + cells * 4) + (w + cfg.r) * 4, b * 27 * h * w)}


def auto_batch_tile(
    cfg: BGConfig,
    h: int,
    w: int,
    n_frames: Optional[int] = None,
    *,
    stream_input: bool = False,
    mesh_size: int = 1,
    temporal: bool = False,
    precision: str = "fp32",
) -> int:
    """The largest legal batch tile on the H100 (module docstring): the
    per-device share of the pack ``ceil(n_frames / mesh_size)``, capped at
    ``MAX_AUTO_TILE`` (the cap alone when the pack size is unknown).

    Raises ``ValueError`` as ``launch_geometry`` (``stream_input``:
    ``stream_geometry``) raises, when one stripe of one column cell of an
    ``h x w`` frame does not fit a block's shared memory on the card.
    """
    from repro_torch.kernels.bg_fused import H100_SMEM_OPTIN, launch_geometry, stream_geometry

    esize = precision_bytes(precision)
    if stream_input:
        stream_geometry(1, h, w, cfg, H100_SMS, H100_SMEM_OPTIN, esize=esize)
    else:
        launch_geometry(1, h, w, cfg, H100_SMS, H100_SMEM_OPTIN, temporal=temporal, esize=esize)
    bt = MAX_AUTO_TILE
    if n_frames is not None:
        bt = min(bt, -(-int(n_frames) // max(1, mesh_size)))
    return int(max(1, bt))


def plan_cost_breakdown(plan: "BGPlan", h: int, w: int,
                        n_frames: Optional[int] = None) -> dict:
    """Term-by-term H100 estimate for dispatching ``plan`` on ``(n_frames, h,
    w)`` frames (module docstring). Returns ``flops``, ``hbm_bytes``,
    ``steps`` (kernel launches), ``compute_s``, ``memory_s``,
    ``overhead_s``, ``bound_s`` (``max(compute, memory)``) and ``total_s``
    (the sum that ranks candidates). Covers the kernel backends only:
    ``"reference"`` and ``"streaming"``, which :func:`plan_for` never
    ranks, raise ``ValueError``. A mesh plan is costed on one device's
    shard ``ceil(n_frames / mesh_size)``, as in the JAX package (distinct
    devices run their shards at once; a mesh that repeats a device runs
    them one after the other, which scales every candidate alike)."""
    cfg = plan.cfg
    n = 1 if n_frames is None else max(1, int(n_frames))
    b = -(-n // plan.mesh_size)  # one device's shard
    gx, gy, gz = grid_shape(h, w, cfg)
    cells = gx * gy * gz
    esize = precision_bytes(plan.precision)
    if plan.backend in _FUSED_BACKENDS:
        steps = -(-b // plan.tile_for(n))
        hbm, flops = fused_work(b, h, w, cfg, esize, plan.temporal)
        hbm += (steps - 1) * (w + cfg.r) * 4  # each launch reads the TI fractions
        if plan.backend == "fused":
            hbm += b * h * w * esize  # GC and TI each read the frame
        if plan.precision == "bf16":
            hbm += b * h * w * 2 * (4 + esize)  # the cast in and the cast out
        overhead = LAUNCH_OVERHEAD_S * steps
        if plan.backend == "fused_streamed":
            overhead += STREAM_LAUNCH_OVERHEAD_S * steps
    elif plan.backend == "staged":
        work = staged_work(b, h, w, cfg).values()
        hbm = sum(nb for nb, _ in work) + b * cells * 12  # normalize: 2 in, 1 out
        flops = sum(fl for _, fl in work) + b * cells
        steps = 4  # B4, B5, the normalization, B6
        overhead = LAUNCH_OVERHEAD_S * steps
    else:
        raise ValueError(
            f"the H100 cost model covers the kernel backends {_KERNEL_BACKENDS}; "
            f"{plan.backend!r} is never ranked (plan_cost_measured times any plan)"
        )
    overhead += FRAME_OVERHEAD_S * b
    compute_s = flops / FP32_FLOPS_PER_S
    memory_s = hbm / HBM_BYTES_PER_S
    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm),
        "steps": int(steps),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "overhead_s": overhead,
        "bound_s": max(compute_s, memory_s),
        "total_s": compute_s + memory_s + overhead,
    }


def plan_cost(plan: "BGPlan", h: int, w: int, n_frames: Optional[int] = None) -> float:
    """Predicted seconds to dispatch ``plan`` on ``(n_frames, h, w)`` frames:
    the ranking key :func:`plan_for` minimizes."""
    return plan_cost_breakdown(plan, h, w, n_frames)["total_s"]


def plan_cost_measured(plan: "BGPlan", h: int, w: int, n_frames: int = 1, reps: int = 20,
                       *, frames: Optional[torch.Tensor] = None, warmup: int = 3) -> float:
    """Measured seconds per dispatch of ``plan`` on ``(n_frames, h, w)``
    frames (``frames``, or random 8-bit frames made on the plan's device):
    the mean of ``reps`` back-to-back calls after ``warmup`` calls, timed by
    CUDA events on a card (the host's launch work included where it is the
    slower side), by the host clock on the CPU. A temporal plan is timed on
    a carry it warmed itself, at alpha 0.6. This replaces the JAX package's
    ``plan_cost_hlo``, which compiled XLA HLO."""
    dev = plan.device
    if frames is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        frames = torch.floor(torch.rand((n_frames, h, w), generator=gen, device=dev) * 256.0)
    frames = frames.to(dev, torch.float32).contiguous()
    if plan.temporal:
        n = frames.shape[0]
        zero = torch.zeros((n, *grid_shape(h, w, plan.cfg), 2), dtype=plan.storage_dtype, device=dev)
        carry = plan(frames, carry=zero, alpha=torch.zeros(n, device=dev))[1]
        alpha = torch.full((n,), 0.6, device=dev)

        def call():
            return plan(frames, carry=carry, alpha=alpha)
    else:

        def call():
            return plan(frames)

    for _ in range(warmup):
        call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps


@dataclasses.dataclass(frozen=True)
class BGPlan:
    """One frozen, hashable record of every bilateral-grid dispatch decision.

    Fields:
      cfg:             the grid/window configuration (frozen ``BGConfig``).
      backend:         ``"reference"``, ``"streaming"``, ``"fused"``,
                       ``"fused_streamed"`` or ``"staged"`` (module
                       docstring).
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
                       plain versions. With a mesh: the mesh's first device
                       (``None`` or that device may be passed).
      mesh:            a :class:`repro_torch.sharding.BatchMesh` splitting the
                       frame / stream batch axis over its devices, or
                       ``None`` for one device. A size-1 mesh becomes
                       ``None`` (the plain call on its device); the
                       ``"reference"`` and ``"staged"`` backends do not
                       shard (``ValueError``), as in the JAX package.
    """

    cfg: BGConfig
    backend: str = "fused"
    temporal: bool = False
    batch_tile: Optional[int] = None
    quantize_output: bool = True
    precision: str = "fp32"
    device: Union[str, torch.device, None] = None
    mesh: Optional[BatchMesh] = None

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
        device = self.device
        if self.mesh is not None:
            if not isinstance(self.mesh, BatchMesh):
                raise TypeError(
                    f"mesh must be a repro_torch.sharding.BatchMesh or None, got "
                    f"{type(self.mesh).__name__}"
                )
            first = self.mesh.devices[0]
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != first.type
                                     or want.index not in (None, first.index)):
                raise ValueError(
                    f"a mesh plan runs on its mesh's first device {first}, got device={device}"
                )
            device = first
            if self.mesh.size == 1:
                object.__setattr__(self, "mesh", None)  # degrade to plain
            elif self.backend not in _MESH_BACKENDS:
                raise ValueError(
                    f"backend {self.backend!r} does not shard over a mesh; "
                    f"mesh plans need one of {_MESH_BACKENDS}"
                )
        object.__setattr__(self, "device", resolve_device(device))

    # ------------------------------------------------------------ utilities
    @property
    def mesh_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def input_device(self) -> Optional[torch.device]:
        """Where a dispatch takes its inputs: the plan's device, or ``None``
        for a mesh plan, whose inputs stay where the caller has them (host
        staging too) and whose shards each move to their own device."""
        return self.device if self.mesh is None else None

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
        """Frames per kernel launch for an ``n_frames`` pack: the per-device
        shard ``ceil(n_frames / mesh_size)`` (the whole pack on one device)
        when ``batch_tile`` is ``None``, else ``batch_tile`` cut to the
        shard. The video packer asks the plan for it per pack."""
        shard = -(-max(1, int(n_frames)) // self.mesh_size)
        return shard if self.batch_tile is None else min(self.batch_tile, shard)

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

    def fallback_ladder(self) -> Tuple["BGPlan", ...]:
        """The degradation ladder for fault-tolerant serving: this plan
        first, then simpler variants, each on this plan's device. On the
        CPU it is the JAX package's (``fused_streamed -> fused ->
        reference``; any other backend, ``"streaming"`` too, falls straight
        to ``reference``). On a card it ends at the last kernel rung
        (``fused_streamed -> fused``; any other backend alone): the
        ``reference`` rung there would answer a failed kernel from plain
        PyTorch on the card, so a card plan never degrades past its
        kernels, and a ``"streaming"`` plan, plain PyTorch by design, has
        no rung below it there. ``temporal`` and
        ``precision`` survive every rung (``fused`` and ``reference`` both
        carry the grid EMA and both storage types); a ``reference`` rung
        sheds the mesh (it does not shard; it runs on the mesh's first
        device) and its ``batch_tile`` normalizes away. Consumed by
        ``repro_torch.reliability.GuardedDispatch``."""
        ladder = [self]
        if self.backend == "fused_streamed":
            ladder.append(self.with_options(backend="fused"))
        if self.backend != "reference" and self.device.type == "cpu":
            ladder.append(self.with_options(backend="reference", mesh=None, batch_tile=None))
        return tuple(ladder)

    # -------------------------------------------------------- serialization
    def to_json(self) -> dict:
        """The JAX package's version-1 payload (``repro.plan.BGPlan.to_json``).
        The devices are not part of it, the mesh's size is: a loading host
        binds its own (:meth:`from_json`)."""
        return {
            "version": 1,
            "cfg": dataclasses.asdict(self.cfg),
            "backend": self.backend,
            "temporal": self.temporal,
            "batch_tile": self.batch_tile,
            "mesh_size": self.mesh_size,
            "quantize_output": self.quantize_output,
            "interpret": None,
            "precision": self.precision,
        }

    @classmethod
    def from_json(cls, data: dict, *, mesh="auto", device=None) -> "BGPlan":
        """Rebuild a plan from a version-1 payload, written by either package,
        bound to ``device``. ``mesh="auto"`` builds a mesh of the payload's
        ``mesh_size`` over this host's first cards (``batch_mesh``),
        raising ``ValueError`` when the host has fewer (a silently shrunk
        mesh would shift the dispatch geometry the hash vouches for); pass a
        ``BatchMesh``, or ``None`` for one device, to rebind. ``interpret``
        is a Pallas setting and is ignored."""
        if int(data.get("version", 1)) != 1:
            raise ValueError(
                f"unknown BGPlan serialization version {data.get('version')!r}"
            )
        if isinstance(mesh, str) and mesh == "auto":
            ms = int(data.get("mesh_size", 1))
            if ms <= 1:
                mesh = None
            else:
                count = torch.cuda.device_count() if torch.cuda.is_available() else 0
                if count < ms:
                    raise ValueError(
                        f"serialized plan wants a {ms}-device mesh but only {count} "
                        f"card(s) are visible; pass mesh= explicitly to rebind"
                    )
                from repro_torch.sharding.bg_shard import batch_mesh

                mesh = batch_mesh(ms)
        return cls(
            cfg=BGConfig(**data["cfg"]),
            backend=data["backend"],
            temporal=bool(data.get("temporal", False)),
            batch_tile=data.get("batch_tile"),
            quantize_output=bool(data.get("quantize_output", True)),
            precision=data.get("precision", "fp32"),
            device=device,
            mesh=mesh,
        )

    def plan_hash(self) -> str:
        """Stable hex digest of :meth:`to_json`: the JAX package's hash of an
        equal payload, character for character (two hosts agree on a
        dispatch recipe when their hashes match)."""
        payload = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    @property
    def provenance(self) -> str:
        """How this plan was chosen: ``"cache"`` (measured-plan cache hit),
        ``"model"`` (ranked by the cost model in :func:`plan_for`),
        ``"explicit"`` (``plan_for`` with every free decision pinned) or
        ``"default"`` (constructed directly). Not part of equality or the
        hash."""
        return self.__dict__.get("_provenance", "default")

    def describe(self) -> str:
        """One-line dispatch summary for logs."""
        return (
            f"backend={self.backend} bt={self.batch_tile} mesh={self.mesh_size} "
            f"temporal={int(self.temporal)} prec={self.precision} "
            f"src={self.provenance} device={self.device}"
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
        the result stays there, float32. A mesh plan leaves the frames where
        they are and moves each shard to its own device; the result is
        gathered on the plan's device (the mesh's first).

        A temporal plan takes (h, w) or (n, h, w) frames with ``carry`` (the
        ``(n, gx, gy, gz, 2)`` carries, moved to the device in the storage
        type, as the JAX package's ``carry.astype(sdt)``) and ``alpha`` and
        returns ``(out, new_carry)``, the carry in the storage type. A host
        alpha (scalar, list or numpy) is broadcast to ``(n,)`` and
        range-checked here, once; a tensor alpha is trusted, as checking a
        device tensor would wait for the card.

        The dispatch hook (:func:`set_dispatch_hook`) runs first; an
        exception it raises aborts the dispatch."""
        if _DISPATCH_HOOK is not None:
            _DISPATCH_HOOK(self)
        dev = self.input_device
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        if self.temporal:
            if carry is None or alpha is None:
                raise ValueError("temporal plan dispatch needs both carry= and alpha=")
            if not isinstance(carry, torch.Tensor):
                carry = torch.as_tensor(np.asarray(carry, np.float32))
            carry = carry.to(device=dev or carry.device, dtype=self.storage_dtype)
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
                alpha = alpha.to(device=dev or alpha.device, dtype=torch.float32)
                if alpha.dim() == 0:
                    alpha = alpha.expand(n)
            else:
                alpha_np = np.broadcast_to(np.asarray(alpha, np.float32), (n,))
                if (alpha_np < 0.0).any() or (alpha_np >= 1.0).any():
                    raise ValueError(f"temporal alpha must be in [0, 1), got {alpha}")
                alpha = torch.as_tensor(alpha_np.copy(), device=dev)
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


# ------------------------------------------------------------------ plan_for
def candidate_plans(cfg: BGConfig, height: int, width: int, *, n_frames: Optional[int] = None,
                    temporal: bool = False, backends=("fused", "fused_streamed"),
                    precisions=PRECISIONS, batch_tile: Optional[int] = None,
                    quantize_output: bool = True, device=None, mesh=None) -> list:
    """The grid :func:`plan_for`'s model ranks: ``backends`` x the tile
    ladder up to :func:`auto_batch_tile` (or the pinned ``batch_tile``) x
    ``precisions``, in that order, on ``device`` (or over ``mesh``, the
    ladder then up to the per-device shard). ``chip_smoke.py``'s
    ``plan_sweep`` times the same grid."""
    device = resolve_device(device) if mesh is None else None
    mesh_size = 1 if mesh is None else mesh.size
    plans = []
    for prec in precisions:
        for be in backends:
            if batch_tile is not None:
                tiles = [batch_tile]
            else:
                cap = auto_batch_tile(cfg, height, width, n_frames, stream_input=be == "fused_streamed",
                                      mesh_size=mesh_size, temporal=temporal, precision=prec)
                tiles = sorted({t for t in _TILE_LADDER if t < cap} | {cap})
            plans.extend(BGPlan(cfg=cfg, backend=be, temporal=temporal, batch_tile=t,
                                quantize_output=quantize_output, precision=prec, device=device,
                                mesh=mesh)
                         for t in tiles)
    return plans


def _stamp(plan: BGPlan, provenance: str) -> BGPlan:
    object.__setattr__(plan, "_provenance", provenance)
    return plan


def plan_for(
    cfg: BGConfig,
    height: int,
    width: int,
    *,
    n_frames: Optional[int] = None,
    temporal: bool = False,
    backend: Optional[str] = None,
    sharded: Optional[bool] = None,
    mesh=None,
    batch_tile: Optional[int] = None,
    stream_input: Optional[bool] = None,
    quantize_output: bool = True,
    precision: Optional[str] = None,
    cache=None,
    device=None,
) -> BGPlan:
    """Build a concrete :class:`BGPlan` for the given frame geometry (the
    JAX package's ``plan_for``, on the H100 cost model).

    Free decisions (``"fused"`` or ``"fused_streamed"`` through
    ``stream_input``, ``batch_tile``) are resolved in order: the
    measured-plan cache (:mod:`repro_torch.plan_cache`; ``cache=None`` uses
    the process default, a :class:`~repro_torch.plan_cache.PlanCache` pins
    one, ``False`` skips the lookup), consulted only when nothing is
    pinned, then the cost model (:func:`plan_cost`) over every legal
    candidate. Pinned values skip both; :attr:`BGPlan.provenance` records
    which route won. Per frame the candidates are ``"fused"`` and
    ``"fused_streamed"``, temporal ``"fused"`` only, each at the tile ladder
    up to :func:`auto_batch_tile`; ``"staged"`` and ``"reference"`` are
    never picked, only pinned.

    ``precision``: ``None`` keeps every candidate fp32 (a numerics decision
    is never made for the caller), ``"fp32"`` / ``"bf16"`` pin it, ``"auto"``
    ranks bf16 beside fp32 on the fused family (exact-cost ties keep fp32).
    A cached bf16 winner is used only under ``"auto"`` or ``"bf16"``.

    ``device`` is the plan's device (``None``: the CUDA card); the cache key
    carries its fingerprint and the mesh size. ``sharded=None`` auto-meshes
    over every card (``repro_torch.sharding.batch_mesh``) when the caller
    wants the card (``device`` ``None`` or ``"cuda"``), more than one is
    visible and every candidate backend shards (``"reference"`` and
    ``"staged"`` stay on one device); ``sharded=False`` forces one device;
    ``sharded=True`` needs a backend that shards (``ValueError``) and
    meshes as ``None`` does; an explicit ``mesh`` wins (a size-1 mesh is
    its device). A ``batch_tile`` above the per-device shard
    ``ceil(n_frames / mesh_size)`` raises ``ValueError``, and the cost model
    ranks the per-device shard, as in the JAX package.
    """
    if precision not in (None, "auto") and precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {(None, 'auto') + PRECISIONS}, got {precision!r}"
        )
    fully_auto = (
        backend is None and stream_input is None and batch_tile is None
        and precision in (None, "auto")
    )
    if backend is None:
        if temporal:
            if stream_input:
                raise ValueError("stream_input does not compose with a temporal carry")
            candidates = ("fused",)
        elif stream_input is None:
            candidates = ("fused", "fused_streamed")
        else:
            candidates = ("fused_streamed",) if stream_input else ("fused",)
    else:
        if (
            stream_input is not None
            and (backend == "fused_streamed") != bool(stream_input)
            and backend in _FUSED_BACKENDS
        ):
            raise ValueError(f"stream_input={stream_input} contradicts backend={backend!r}")
        candidates = (backend,)

    mesh_capable = all(b in _MESH_BACKENDS for b in candidates)
    if sharded and not mesh_capable:
        raise ValueError(
            f"sharded=True needs a mesh-capable backend {_MESH_BACKENDS}, got {backend!r}"
        )
    if sharded is False:
        mesh = None
    elif mesh is None and mesh_capable:
        # auto-mesh only for backends that shard; an explicit mesh on a
        # backend that does not falls through to BGPlan's ValueError
        from repro_torch.sharding.bg_shard import _service_mesh

        mesh = _service_mesh(None, device)
    if mesh is not None:
        if not isinstance(mesh, BatchMesh):
            raise TypeError(f"mesh must be a repro_torch.sharding.BatchMesh, got {type(mesh).__name__}")
        if device is None:
            device = mesh.devices[0]
        if mesh.size == 1:
            mesh = None
    device = resolve_device(device)
    mesh_size = 1 if mesh is None else mesh.size

    if batch_tile is not None and mesh_size > 1 and n_frames is not None:
        shard = -(-int(n_frames) // mesh_size)
        if batch_tile > shard:
            raise ValueError(
                f"batch_tile={batch_tile} exceeds the {shard} frame(s) each of the "
                f"{mesh_size} mesh devices receives for n_frames={n_frames}; the kernel "
                f"would clamp the tile (shifting the temporal-carry dispatch geometry): "
                f"use batch_tile<={shard} or batch_tile=None (auto)"
            )

    def build(be, bt, prec):
        return BGPlan(cfg=cfg, backend=be, temporal=temporal, batch_tile=bt,
                      quantize_output=quantize_output, precision=prec, device=device,
                      mesh=mesh)

    fused_family = all(b in _FUSED_BACKENDS for b in candidates)
    if precision == "bf16":
        precisions = ("bf16",)
    elif precision == "auto" and fused_family:
        precisions = ("fp32", "bf16")
    else:
        precisions = ("fp32",)

    if (len(candidates) == 1 and len(precisions) == 1
            and (batch_tile is not None or not fused_family)):
        # every decision pinned (or a backend with none to make)
        return _stamp(build(candidates[0], batch_tile, precisions[0]), "explicit")

    # ---- the measured-plan cache (fully automatic calls only: a cached
    # entry is a complete decision and must not override a pinned argument)
    if fully_auto and cache is not False:
        from repro_torch.plan_cache import get_default_cache, workload_key

        pc = get_default_cache() if cache is None else cache
        ent = pc.lookup(workload_key(cfg, height, width, n_frames, temporal, mesh_size,
                                     device=device))
        if ent is not None:
            try:
                pj = ent["plan"]
                be, bt = pj["backend"], pj.get("batch_tile")
                prec = pj.get("precision", "fp32")
                # a cached bf16 winner must not reach a caller that did not
                # opt into reduced precision
                ok = be in candidates and prec in precisions
                if ok and bt is not None and mesh_size > 1 and n_frames is not None:
                    ok = bt <= -(-int(n_frames) // mesh_size)
                if ok:
                    return _stamp(build(be, bt, prec), "cache")
            except (KeyError, TypeError, ValueError):
                pass  # stale or incompatible entry: the model decides

    # ---- the cost model over the legal candidate grid
    plans = candidate_plans(cfg, height, width, n_frames=n_frames, temporal=temporal,
                            backends=candidates, precisions=precisions, batch_tile=batch_tile,
                            quantize_output=quantize_output, device=device, mesh=mesh)
    n_eval = int(n_frames) if n_frames is not None else max(p.batch_tile for p in plans)
    best = min(
        plans,
        key=lambda p: (
            plan_cost(p, height, width, n_eval),
            p.precision != "fp32",  # exact tie: precision costs quality
            p.backend != "fused",  # exact tie: the simpler kernel
            -p.batch_tile,
        ),
    )
    return _stamp(best, "model")


# ------------------------------------------------------------ dispatch hook
# One process-wide host-side hook run at the top of every BGPlan.__call__,
# before any device work: the integration point for fault injection
# (FaultInjector.plan_hook) and tracing. None (the default) costs one global
# load per dispatch.
_DISPATCH_HOOK = None


def set_dispatch_hook(hook):
    """Install ``hook(plan)`` as the global pre-dispatch hook; returns the
    previous hook (restore it when done; ``FaultInjector.plan_hook`` is the
    context-managed form). Pass ``None`` to clear."""
    global _DISPATCH_HOOK
    prev = _DISPATCH_HOOK
    _DISPATCH_HOOK = hook
    return prev


def _mesh_call(inner, mesh: BatchMesh, n_in: int, n_out: int):
    """The shared mesh composition (the JAX package's ``_mesh_call``, with a
    loop over devices for ``shard_map``): split every input's leading axis
    into ``mesh.size`` equal shards, the last ones zero-padded (``_row_pad``)
    on their own device, run ``inner`` on each shard with its device
    current, and gather the shards' real rows onto the mesh's first device
    in order. Returns ``fn(*tensors) -> output`` (a tuple for ``n_out >
    1``). Shard inputs move by ``non_blocking`` copies: from pinned host
    memory they overlap the launches, so the caller keeps such a buffer
    unchanged until the dispatch completes (``AsyncFrameEngine`` keeps its
    staging until the batch's event). Each shard's outputs are copied to the
    first device, a copy PyTorch orders after the shard's work, so that
    device's current stream covers every shard."""
    from repro_torch.sharding.bg_shard import _on, _pad_rows, _row_pad

    devices = mesh.devices
    first = devices[0]

    def call(*tensors):
        if len(tensors) != n_in:
            raise TypeError(f"a mesh dispatch takes {n_in} tensor(s), got {len(tensors)}")
        n = tensors[0].shape[0]
        per = (n + _row_pad(len(devices), n)) // len(devices)
        parts = []
        for k, dev in enumerate(devices):
            lo, hi = min(k * per, n), min((k + 1) * per, n)
            with _on(dev):
                shard = [_pad_rows(t[lo:hi].to(dev, non_blocking=True), per - (hi - lo))
                         for t in tensors]
                out = inner(*shard)
            outs = (out,) if n_out == 1 else tuple(out)
            parts.append([o[:hi - lo] for o in outs])
        with _on(first):
            gathered = tuple(torch.cat([p[i].to(first, non_blocking=True) for p in parts])
                             for i in range(n_out))
        return gathered[0] if n_out == 1 else gathered

    return call


@functools.lru_cache(maxsize=256)
def _plan_executable(plan: BGPlan):
    """ONE callable per plan: the compute route plus output quantization.
    Under ``precision="fp32"`` every storage cast below is the identity. A
    mesh plan runs the same route per shard (:func:`_mesh_call`) and
    quantizes the gathered output."""
    cfg = plan.cfg
    quant = plan.quantize_output
    prec = plan.precision
    sdt = plan.storage_dtype
    mesh = plan.mesh

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

        def inner_temporal(frames, carry, alpha):
            return bg_fused(frames.to(sdt), cfg, batch_tile=plan.batch_tile, carry=carry,
                            alpha=alpha, precision=prec)

        if mesh is not None:
            inner_temporal = _mesh_call(inner_temporal, mesh, n_in=3, n_out=2)

        def fn(frames, carry, alpha):
            out, new_carry = inner_temporal(frames, carry, alpha)
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

    if plan.backend == "streaming":
        from repro_torch.core.streaming import _streaming_batch

        def batch(frames):
            return _streaming_batch(frames, cfg, quant)

        meshed = batch if mesh is None else _mesh_call(batch, mesh, n_in=1, n_out=1)

        def fn(frames):
            if frames.dim() == 3:
                return meshed(frames)
            # a single frame: the plain stripe loop on the plan's device
            return _streaming_batch(frames[None].to(plan.device), cfg, quant)[0]

        return fn

    if plan.backend == "staged":
        from repro_torch.kernels.ops import _staged_single

        def fn(frames):
            return _maybe_quantize(_staged_single(frames, cfg))

        return fn

    from repro_torch.kernels.bg_fused import bg_fused

    stream_input = plan.backend == "fused_streamed"

    def inner(frames):
        return bg_fused(frames.to(sdt), cfg, batch_tile=plan.batch_tile, stream_input=stream_input,
                        precision=prec)

    if mesh is None:

        def fn(frames):
            return _maybe_quantize(inner(frames))

        return fn

    meshed = _mesh_call(inner, mesh, n_in=1, n_out=1)

    def fn(frames):
        squeeze = frames.dim() == 2
        out = _maybe_quantize(meshed(frames[None] if squeeze else frames))
        return out[0] if squeeze else out

    return fn
