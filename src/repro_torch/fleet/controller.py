"""The fleet's plan controller: one dispatch recipe for every worker (the
port of ``repro/fleet/controller.py``).

Temporal carries are bit-products of a specific dispatch geometry (backend,
batch tile, storage type): rebalancing a stream onto a worker running a
*different* geometry would splice two incompatible recursions. The
controller makes that impossible by construction: it resolves **one**
:class:`~repro_torch.plan.BGPlan` via :func:`~repro_torch.plan.plan_for`
(measured-plan cache -> the H100 cost model, exactly the single-engine
path), serializes it once (``to_json`` + ``plan_hash``), and every worker
is built from that one payload. :meth:`verify` re-checks the fleet after
construction and refuses any worker whose hash disagrees
(:class:`~repro_torch.fleet.errors.PlanMismatch`).

The payload is the JAX package's (``{plan, plan_hash, provenance}``, the
version-1 plan JSON): a pinned plan hashes alike in both packages, so a
payload of either loads into a worker of the other. ``plan_for``'s
unpinned picks may differ between them (the port ranks on the H100 cost
model).

:meth:`bless` records the resolved plan into a
:class:`~repro_torch.plan_cache.PlanCache` file under the controller's
workload key: the shippable artifact. Run the controller on one host,
``python -m repro_torch.plan_cache merge`` the blessed file into the
fleet's cache, and every worker's ``plan_for`` resolves the same recipe.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import BGConfig
from repro_torch.plan import BGPlan, plan_for
from repro_torch.plan_cache import PlanCache, workload_key

from .errors import PlanMismatch

__all__ = ["PlanController"]


class PlanController:
    """Resolves, serializes, and distributes one fleet-wide ``BGPlan``."""

    def __init__(
        self,
        plan: Optional[BGPlan] = None,
        *,
        cfg: Optional[BGConfig] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        streams_per_worker: Optional[int] = None,
        temporal: bool = True,
        cache=None,
        **plan_kwargs,
    ):
        """Either hand an explicit ``plan`` or the workload geometry
        (``cfg``/``height``/``width`` [+ ``streams_per_worker``, the
        per-worker pack size ``plan_for`` tunes the batch tile against]) and
        the controller resolves one via ``plan_for``. Extra ``plan_kwargs``
        (``device=``, ``sharded=``, pins) pass through; the plan's device is
        the one its cost model and cache key are for, and workers bind
        their own."""
        if plan is None:
            if cfg is None or height is None or width is None:
                raise TypeError(
                    "PlanController needs plan= or (cfg=, height=, width=)"
                )
            plan = plan_for(
                cfg,
                height,
                width,
                n_frames=streams_per_worker,
                temporal=temporal,
                cache=cache,
                **plan_kwargs,
            )
        self.plan = plan
        self._geometry = (height, width, streams_per_worker)

    @property
    def plan_hash(self) -> str:
        return self.plan.plan_hash()

    def payload(self) -> dict:
        """The worker-construction payload: the serialized plan plus the
        controller's own hash of it (the worker re-hashes after rebuild and
        refuses a disagreement) and provenance for logs."""
        return {
            "plan": self.plan.to_json(),
            "plan_hash": self.plan_hash,
            "provenance": self.plan.provenance,
        }

    def verify(self, workers: Sequence) -> None:
        """Refuse a mixed-hash fleet: every worker must serve exactly the
        controller's dispatch recipe."""
        want = self.plan_hash
        bad = {w.wid: w.plan_hash for w in workers if w.plan_hash != want}
        if bad:
            raise PlanMismatch(
                f"mixed-plan fleet: controller plan_hash={want!r} but "
                f"worker(s) {bad!r} disagree — temporal carries are not "
                f"portable across dispatch geometries"
            )

    def bless(self, path: Optional[str] = None, *,
              measured_us: Optional[float] = None) -> str:
        """Record the resolved plan into the plan-cache file at ``path``
        (default: the process-default cache path) under this controller's
        workload key, for the plan's device. Returns the key. Requires
        geometry (the ``plan_for`` construction route): an explicit-plan
        controller has no workload to key on."""
        height, width, streams_per_worker = self._geometry
        if height is None or width is None:
            raise ValueError(
                "bless() needs the geometry-constructed controller "
                "(cfg/height/width) — an explicit plan= has no workload key"
            )
        key = workload_key(
            self.plan.cfg,
            height,
            width,
            n_frames=streams_per_worker,
            temporal=self.plan.temporal,
            mesh_size=self.plan.mesh_size,
            device=self.plan.device,
        )
        PlanCache(path).record(
            key, self.plan, measured_us=measured_us, source="controller"
        )
        return key

    def __repr__(self):
        return (
            f"PlanController(plan_hash={self.plan_hash!r}, "
            f"plan=[{self.plan.describe()}])"
        )
