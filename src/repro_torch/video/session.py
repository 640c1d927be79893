"""Per-stream sessions and the multi-stream packer: the port of
``repro/video/session.py``.

A video service handles N concurrent streams, each an ordered frame sequence
with its own temporal state. The packer turns "one frame from each live
stream" into one dispatch: frames stack on a leading stream axis, the
per-stream blurred-grid carries stack into one ``(n, gx, gy, gz, 2)``
tensor, and a per-stream alpha vector lets warm streams (``a_s``), cold
streams and first-frame streams (forced ``a = 0``) share it. Row i of the
stacked carry is read and written only by stream i. Carries live on the
plan's device in its storage type (``torch.bfloat16`` for a bf16 plan).
With a mesh plan the pack's stream axis is split over the mesh: each
stream's frame, carry row and alpha go to its shard's device, and the
outputs and advanced carries are gathered back on the plan's device (the
mesh's first); the per-pack tile is the plan's, clamped to the shard.

Every pack is one dispatch: on the card, one launch of the temporal kernel
B2, or of the per-frame kernel B1 when no stream in the pack is warm (no
session holds a carry and every alpha is 0, so nothing temporal is
materialized). An ``a == 0`` row's in-kernel blend is the exact float
identity, so cold streams get the per-frame output bit for bit whichever
warm streams share their pack.

:meth:`MultiStreamPacker.pack_guarded` is ``pack`` plus a
:class:`repro_torch.reliability.DispatchGuard`: per-row ``torch.isfinite``
flags over the pack's outputs and advanced carries, launched with the
dispatch and read by the engine at completion. A bad carry row is cured by
:meth:`MultiStreamPacker.quarantine`, which resets the stream to cold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.bilateral_grid import BGConfig
from repro_torch.reliability.guards import (
    DEFAULT_CARRY_LIMIT,
    DispatchGuard,
    carry_ok_rows,
    finite_rows,
)

from .temporal import carry_shape, temporal_denoise

__all__ = ["StreamSession", "MultiStreamPacker"]


@dataclasses.dataclass
class StreamSession:
    """State of one live video stream.

    ``carry`` is ``None`` until the stream's first temporal frame has been
    packed, and stays ``None`` for ``alpha == 0`` streams.
    """

    sid: Hashable
    alpha: float = 0.0
    carry: Optional[torch.Tensor] = None
    frames_seen: int = 0

    def __post_init__(self):
        if not 0.0 <= self.alpha < 1.0:
            raise ValueError(f"stream {self.sid!r}: alpha must be in [0, 1)")


class MultiStreamPacker:
    """Batches one frame per live stream into a single temporal dispatch.

    Construct with ``plan=`` (a :class:`repro_torch.plan.BGPlan`; the packer
    asks it for each pack's tile and derives its temporal variant), or with
    ``cfg=`` and optionally ``device=`` and ``mesh=`` for the fused plan
    (``mesh=None``: every card when the caller wants the card and more than
    one is visible).
    """

    def __init__(
        self,
        cfg: BGConfig | None = None,
        quantize_output: bool = True,
        *,
        plan=None,
        device=None,
        mesh=None,
    ):
        if plan is None:
            if cfg is None:
                raise TypeError("MultiStreamPacker needs cfg= or plan=")
            from repro_torch.plan import BGPlan
            from repro_torch.sharding.bg_shard import _service_mesh

            plan = BGPlan(
                cfg=cfg, backend="fused", quantize_output=quantize_output, device=device,
                mesh=_service_mesh(mesh, device),
            )
        elif device is not None or mesh is not None:
            raise ValueError(
                "pass device= and mesh= with cfg=; a plan carries its own device and mesh"
            )
        if plan.backend == "fused_streamed":
            raise ValueError(
                "MultiStreamPacker needs a temporal-capable plan; "
                "backend='fused_streamed' cannot carry the grid EMA"
            )
        self.plan = plan
        self.sessions: Dict[Hashable, StreamSession] = {}
        self.carry_resets = 0  # lifetime count of quarantined carries
        self.carry_restores = 0  # lifetime count of snapshot-restored carries

    @property
    def cfg(self) -> BGConfig:
        return self.plan.cfg

    # ------------------------------------------------------------- streams
    def open(self, sid: Hashable, alpha: float = 0.0) -> StreamSession:
        if sid in self.sessions:
            raise ValueError(f"stream {sid!r} already open")
        sess = StreamSession(sid=sid, alpha=float(alpha))
        self.sessions[sid] = sess
        return sess

    def close(self, sid: Hashable) -> None:
        self.sessions.pop(sid)

    def live(self) -> int:
        return len(self.sessions)

    def quarantine(self, sid: Hashable) -> bool:
        """Reset one stream's temporal carry to cold: its next pack re-warms
        it with effective alpha 0, a standard first frame. Returns True when
        a carry was dropped (counted in ``carry_resets``); an already-cold
        or unknown stream is a no-op."""
        sess = self.sessions.get(sid)
        if sess is None or sess.carry is None:
            return False
        sess.carry = None
        self.carry_resets += 1
        return True

    # ------------------------------------------------------------ snapshots
    def export_carries(self) -> Dict[Hashable, tuple]:
        """Snapshot every warm stream's temporal state as host data:
        ``{sid: (carry ndarray, alpha, frames_seen)}``, numpy copies in the
        JAX package's layout, so a snapshot moves between the packages.
        Cold streams are omitted.

        The carry arrays are float32 (``plan.np_storage_dtype``) for both
        precisions: numpy has no bfloat16, so a bf16 carry leaves as the
        float32 values of its bf16 values, which is lossless, and
        :meth:`restore_carry` gives back the same bits. The fleet's
        snapshots (``repro_torch.fleet.LocalWorker.carry_snapshot``) keep
        the storage type instead, a CPU ``torch.bfloat16`` tensor for bf16,
        and ship its 2-byte words, as the JAX package ships its bf16
        snapshots."""
        out: Dict[Hashable, tuple] = {}
        for sid, sess in list(self.sessions.items()):
            if sess.carry is None:
                continue
            carry = sess.carry.detach().to("cpu", torch.float32).numpy().copy()
            out[sid] = (carry, sess.alpha, sess.frames_seen)
        return out

    def restore_carry(
        self,
        sid: Hashable,
        carry,
        *,
        alpha: Optional[float] = None,
        frames_seen: Optional[int] = None,
    ) -> None:
        """Install a snapshotted carry (host data) onto an open stream, all
        or nothing: every check runs before any session field is assigned,
        so a bad snapshot (wrong geometry, non-finite values, unknown
        stream, bad alpha) leaves the session as it was.

        Any float array is taken (the JAX package's ml_dtypes bfloat16
        arrays too, through ``np.asarray(carry, np.float32)``), and any
        float tensor (a fleet snapshot's CPU ``torch.bfloat16`` one too),
        and rounded to the plan's storage type on install, as the JAX
        package's ``np.asarray(carry, bf16)`` does; within one precision
        that is the identity."""
        sess = self.sessions.get(sid)
        if sess is None:
            raise KeyError(f"stream {sid!r} not open")
        if isinstance(carry, torch.Tensor):
            carry = carry.detach().to("cpu", torch.float32).numpy()
        arr = np.asarray(carry, self.plan.np_storage_dtype)
        if arr.ndim != 4 or arr.shape[-1] != 2:
            raise ValueError(
                f"stream {sid!r}: carry must be (gx, gy, gz, 2), got shape {arr.shape}"
            )
        if not np.isfinite(arr).all():
            raise ValueError(f"stream {sid!r}: refusing to restore a non-finite carry")
        if alpha is not None and not 0.0 <= float(alpha) < 1.0:
            raise ValueError(f"stream {sid!r}: restored alpha must be in [0, 1)")
        # checks complete: commit from here down
        sess.carry = torch.as_tensor(arr.copy()).to(self.plan.device, self.plan.storage_dtype)
        if alpha is not None:
            sess.alpha = float(alpha)
        if frames_seen is not None:
            sess.frames_seen = int(frames_seen)
        self.carry_restores += 1

    # ---------------------------------------------------------------- pack
    def pack(self, frames: Dict[Hashable, object], *, plan=None) -> Dict[Hashable, torch.Tensor]:
        """Denoise one frame from each given stream in one batched dispatch.

        ``frames`` maps stream id -> (h, w) frame (numpy or tensor); every
        id must be open and appear once, and all frames share one (h, w).
        Returns stream id -> denoised frame on the plan's device and
        advances each stream's carry and counter. ``plan=`` dispatches an
        alternate base plan (a fallback-ladder rung) for this pack only; it
        must share the packer plan's device and storage type, since the
        carries live there.
        """
        results, _ = self.pack_guarded(frames, plan=plan)
        return results

    def pack_guarded(self, frames: Dict[Hashable, object], *, plan=None,
                     carry_limit: Optional[float] = None):
        """:meth:`pack` plus a ``DispatchGuard``.

        Returns ``(results, guard)``: ``guard.out_ok`` holds per-row output
        finite flags in ``guard.order`` (the pack's sorted stream-id order)
        and ``guard.carry_ok`` per-stream carry health flags (finite and
        ``|carry| < carry_limit``) for ``guard.carry_sids``, the streams
        whose carry advanced. The flags are device reductions launched with
        the dispatch. The host waits for the card at two blocking copies
        from the host, the alpha vector and the warm rows' index, each a
        ``wait.*`` span of ``repro_torch.tracing`` (and at each host frame).
        """
        if carry_limit is None:
            carry_limit = DEFAULT_CARRY_LIMIT
        if not frames:
            return {}, DispatchGuard()
        with tracing.span("packer.pack", len(frames)):
            return self._pack(frames, plan, carry_limit)

    def _pack(self, frames, plan, carry_limit):
        missing = [s for s in frames if s not in self.sessions]
        if missing:
            raise KeyError(f"streams not open: {missing!r}")
        sids = sorted(frames, key=repr)
        dev = self.plan.device
        # a mesh plan takes the frames where they are: each shard moves itself
        arrs = tracing.as_frames([frames[s] for s in sids], self.plan.input_device, "packer.stage")
        shapes = {tuple(a.shape) for a in arrs}
        if len(shapes) != 1 or len(next(iter(shapes))) != 2:
            raise ValueError(f"pack needs equal (h, w) frames, got {sorted(shapes)}")
        sessions = {s: self.sessions[s] for s in sids}
        batch = torch.stack(arrs)
        warm = [s for s in sids if sessions[s].alpha > 0.0]
        # the packer asks the plan for this pack's tile
        base = self.plan if plan is None else plan
        if base.device != dev or base.precision != self.plan.precision:
            raise ValueError(
                f"pack(plan=) must share the packer's device {dev} and precision "
                f"{self.plan.precision!r}, got {base.device} and {base.precision!r}"
            )
        plan = base.with_tile(base.tile_for(len(sids)))
        results = {}
        carry_sids = ()
        carry_ok = None

        if not warm:
            # all-cold pack: the per-frame path, nothing temporal anywhere
            out, _ = temporal_denoise(batch, alpha=0.0, plan=plan)
            for i, s in enumerate(sids):
                results[s] = out[i]
        else:
            # ONE dispatch for the whole pack: cold rows (and first frames)
            # ride it at alpha 0 with a zero carry row
            zero = torch.zeros(carry_shape(*batch.shape[1:], self.cfg), dtype=plan.storage_dtype, device=dev)
            carry = torch.stack(
                [zero if sessions[s].carry is None else sessions[s].carry for s in sids]
            )
            alpha = np.asarray(
                [sessions[s].alpha if sessions[s].carry is not None else 0.0 for s in sids],
                np.float32,
            )
            out, new_carry = temporal_denoise(batch, carry=carry, alpha=alpha, plan=plan)
            warm_rows = [i for i, s in enumerate(sids) if sessions[s].alpha > 0.0]
            for i, s in enumerate(sids):
                results[s] = out[i]
                if sessions[s].alpha > 0.0:
                    # cold sessions stay carry-free; warm ones advance
                    sessions[s].carry = new_carry[i]
            carry_sids = tuple(sids[i] for i in warm_rows)
            # a list index is copied from the host: a blocking copy
            with tracing.wait("packer.carry_rows", new_carry.device):
                rows = new_carry[warm_rows]
            carry_ok = carry_ok_rows(rows, carry_limit)
        for s in sids:
            sessions[s].frames_seen += 1
        guard = DispatchGuard(
            out_ok=finite_rows(out), order=tuple(sids), carry_sids=carry_sids, carry_ok=carry_ok
        )
        return results, guard
