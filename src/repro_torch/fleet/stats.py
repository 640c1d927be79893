"""Fleet-wide telemetry: per-worker ``EngineStats`` rolled up exactly (the
port of ``repro/fleet/stats.py``).

The fleet's p50/p99 are **merged from the workers' latency reservoirs**
(:meth:`repro_torch.serving.EngineStats.merge` concatenates the per-worker sample
windows and takes percentiles of the union) — never an average of
per-worker percentiles, which understates the tail exactly when one worker
is the problem. Counters sum; queue depths stay per-worker (the router's
backpressure acts on individual backlogs, so the max matters, not the
mean); the router's own counters (shed, rebalanced, quarantined, lost)
ride along so one snapshot answers "what did the fleet absorb".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.serving import EngineStats

__all__ = ["FleetStats"]


@dataclasses.dataclass(frozen=True)
class FleetStats:
    """One fleet-wide snapshot (see :meth:`collect`)."""

    workers: int
    workers_alive: int
    streams: int
    plan_hash: str
    router_shed: int
    rebalanced_streams: int
    quarantined_streams: int
    workers_lost: int
    queue_depths: Tuple[int, ...]
    per_worker: Tuple[EngineStats, ...]
    merged: EngineStats
    # process-isolated workers: failover warm restores vs cold
    # quarantines, snapshot staleness at restore time, transport churn
    restores: int = 0
    restore_staleness_p99: float = 0.0
    reconnects: int = 0
    worker_restarts: int = 0

    @property
    def deadline_miss_rate(self) -> float:
        """Missed deadlines per completed-or-failed request, fleet-wide."""
        done = self.merged.completed + self.merged.failed
        return self.merged.deadline_misses / done if done else 0.0

    def as_dict(self) -> Dict[str, float]:
        """Flat exporter form (bench rows / snapshots): fleet counters,
        the merged engine counters under ``merged_*``, and the depth
        extremes (per-worker reservoirs stay out — they are process-local
        diagnostics, not snapshot material)."""
        d = {
            "workers": self.workers,
            "workers_alive": self.workers_alive,
            "streams": self.streams,
            "router_shed": self.router_shed,
            "rebalanced_streams": self.rebalanced_streams,
            "quarantined_streams": self.quarantined_streams,
            "workers_lost": self.workers_lost,
            "deadline_miss_rate": self.deadline_miss_rate,
            "max_queue_depth": max(self.queue_depths) if self.queue_depths else 0,
            "restores": self.restores,
            "restore_staleness_p99": self.restore_staleness_p99,
            "reconnects": self.reconnects,
            "worker_restarts": self.worker_restarts,
        }
        for k, v in self.merged.as_dict().items():
            d[f"merged_{k}"] = v
        return d

    @classmethod
    def collect(cls, router) -> "FleetStats":
        """Snapshot ``router``'s fleet. Dead workers' stats still count
        when readable — thread-hosted backends keep answering after
        ``kill()`` (the state shares the router's process), so their
        lifetime counters stay in the fleet's history; a dead *process*
        takes its counters with it and is skipped rather than failing the
        whole snapshot."""
        def _stats(w):
            try:
                return w.stats()
            except Exception:
                # a worker that died between the liveness check and the RPC
                # (subprocess backends): its transport counters are gone,
                # but the snapshot must still collect
                return None

        per = tuple(s for s in (_stats(w) for w in router.workers)
                    if s is not None)
        stale = getattr(router, "restore_staleness_samples", ())
        return cls(
            workers=len(router.workers),
            workers_alive=router.workers_alive,
            streams=router.streams,
            plan_hash=router.plan_hash,
            router_shed=router.router_shed,
            rebalanced_streams=router.rebalanced_streams,
            quarantined_streams=router.quarantined_streams,
            workers_lost=router.workers_lost,
            queue_depths=tuple(w.queue_depth() for w in router.workers),
            per_worker=per,
            merged=EngineStats.merge(per),
            restores=getattr(router, "restores", 0),
            restore_staleness_p99=(
                sorted(stale)[min(int(0.99 * len(stale)), len(stale) - 1)]
                if stale else 0.0
            ),
            reconnects=getattr(router, "reconnects", 0),
            worker_restarts=getattr(router, "worker_restarts", 0),
        )
