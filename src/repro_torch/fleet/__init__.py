"""Fleet serving: N workers, one plan, sticky streams (the port of
``repro/fleet``).

The serving-side analog of the paper's never-stalling pipeline at fleet
scale is a router that keeps N :class:`~repro_torch.serving.AsyncFrameEngine`
workers fed without ever moving a warm temporal stream or letting one slow
worker back the fleet up. Two worker backends implement the
plain-data-in/Future-out :class:`~repro_torch.fleet.worker.Worker`
protocol: thread-hosted :class:`LocalWorker` (engine in the router's
process, futures holding tensors on the plan's device) and
process-isolated :class:`SubprocessWorker` (engine in a child process
behind a length-prefixed socket codec, ``repro_torch.fleet.codec`` /
``repro_torch.fleet.remote``, with heartbeats, bounded reconnect, and
periodic warm-carry snapshots shipped back to the router; its futures hold
host arrays).

Request path::

    client --> FleetRouter.submit(frame, stream_id)
                 |  admission: reliability.validate_frame (once, here;
                 |             workers trust the front door)
                 |  placement: affinity table (stream) / least-loaded
                 |             live worker (stateless)
                 |  backpressure: backlog >= max_worker_queue -> shed with
                 |             structured FleetSaturated (the router sheds
                 |             BEFORE any worker queue can overflow)
                 v
               LocalWorker.submit --> AsyncFrameEngine --> Future

On the card every worker ends in the port's kernels through its plan: a
temporal plan's packs launch B2 (``bg_fused_temporal_launch``), a frame
plan's micro-batches B1 or B3 as ``plan_for`` picked; no worker serves
from plain PyTorch on the card.

Affinity rules: stream placement is rendezvous (highest-random-weight)
hashing over live workers, recorded in an explicit affinity table at
``open_stream`` and sticky from then on: a warm temporal carry is a
bit-product of one worker's dispatch sequence and **never migrates while
warm**. The only move is through :meth:`FleetRouter.fail_worker`, which
quarantines first; ``rebalance_log`` records every move for audit.

Plan distribution: a :class:`PlanController` resolves ONE
:class:`~repro_torch.plan.BGPlan` (``plan_for``: measured cache -> the
H100 cost model), serializes it (``to_json`` + ``plan_hash``, the JAX
package's payload), and every worker is built from that payload on its own
device; equal plans share one executable and one loaded kernel library per
process. Mixed-hash fleets are refused at construction
(:class:`PlanMismatch`): carries are not portable across dispatch
geometries.

Failure semantics: worker death is detected three ways (the
:class:`FleetWatchdog` liveness poller, for subprocess workers backed by
``proc.poll()`` + heartbeat freshness; submit-path ``WorkerDown``/
``EngineClosed``; or a tripped per-worker :class:`WorkerHealth` breaker)
and always funnels into ``fail_worker``: kill the worker (its queued
futures fail structurally), then for each victim stream either **restore**
its most recent warm-carry snapshot onto the rendezvous survivor
(all-or-nothing, same plan hash, age <= ``restore_max_age_s``) or fall
back to the cold quarantine re-pin. ``replace_worker`` returns a dead slot
to rotation (the rolling-restart lever).

Failure-mode matrix (backend x failure -> detection -> stream outcome)::

    backend      failure                  detected by            victim streams
    ───────────  ───────────────────────  ─────────────────────  ──────────────────
    LocalWorker  kill()/thread death      watchdog healthy()     cold quarantine
                                          or submit WorkerDown   (snapshots=True:
                                                                 live-read restore)
    LocalWorker  corrupt carry (NaN/Inf)  finite-guard flags     quarantine on the
                 — worker stays up        at completion          same worker
    Subprocess   SIGKILL / OOM / segv     proc.poll() (instant)  snapshot-restore
                 of the child process     + pending sweep        onto survivor;
                                                                 stale/missing ->
                                                                 cold quarantine
    Subprocess   wedged child (alive,     heartbeat staleness    same as SIGKILL
                 not serving)             (heartbeat_timeout_s)  (carries of a hung
                                          + per-RPC timeouts     child are suspect)
    Subprocess   torn/corrupt/dropped     codec CRC + caps ->    none — in-flight
                 wire messages            CodecError; submit     frames fail with
                                          sweep; bounded child   WorkerDown, child
                                          reconnect              reconnects, carries
                                                                 survive in-process
    Subprocess   foreign plan-hash        stamped hash checked   frame refused with
                 frame/snapshot           on submit + restore    PlanMismatch; no
                                                                 cross-geometry EMA

Telemetry: :class:`FleetStats` merges per-worker ``EngineStats`` exactly
(concatenated latency reservoirs, summed counters; see
``EngineStats.merge``) and adds the router's shed/rebalance/quarantine
counters plus ``restores`` / ``restore_staleness_p99`` / ``reconnects`` /
``worker_restarts``. ``Worker.launches()`` gives each worker's kernel
launches (a child's over the stats RPC).

Where the port differs from the JAX fleet: workers take ``device=`` beside
the JAX workers' ``mesh=`` (``"auto"``: a payload's ``mesh_size`` over the
host's first cards; a local worker also takes an explicit
``repro_torch.sharding.BatchMesh``); a subprocess child loads the port's
kernel libraries before READY; results from a child are host arrays, a
local worker's tensors on its device (a mesh plan's first).
"""
from .controller import PlanController
from .errors import (
    CodecError,
    ConnectionClosed,
    FleetError,
    FleetSaturated,
    PlanMismatch,
    WorkerDown,
)
from .health import FleetWatchdog, WorkerHealth
from .remote import SubprocessWorker
from .router import FleetRouter
from .stats import FleetStats
from .worker import CarrySnapshot, LocalWorker, Worker

__all__ = [
    "FleetRouter",
    "PlanController",
    "Worker",
    "LocalWorker",
    "SubprocessWorker",
    "CarrySnapshot",
    "FleetWatchdog",
    "WorkerHealth",
    "FleetStats",
    "FleetError",
    "FleetSaturated",
    "WorkerDown",
    "PlanMismatch",
    "CodecError",
    "ConnectionClosed",
]
