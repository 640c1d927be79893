"""Fault-tolerant serving: the port of ``repro/reliability``.

  ``errors``   structured exception types: every failure a client observes
               through a Future is typed (``AdmissionError``,
               ``DeadlineExceeded``, ``EngineTimeout``, ``NonFiniteOutput``,
               ``AllBackendsFailed``, ``EngineClosed``, ``InjectedFault``),
               and the port's kernel errors (``KernelBuildError``,
               ``KernelLaunchError``).
  ``faults``   deterministic, seedable fault injection (``FaultPlan``,
               ``FaultInjector``) at the engine's hook points, or for every
               plan dispatch through ``FaultInjector.plan_hook()``.
  ``guards``   admission validation at ``submit`` and per-row
               ``torch.isfinite`` flags over outputs and temporal carries;
               a bad carry quarantines its stream.
  ``retry``    bounded retry, per-rung circuit breakers and the backend
               fallback ladder (``BGPlan.fallback_ladder()``:
               ``fused_streamed -> fused -> reference``). Kernel build and
               launch errors are never retried or laddered.

``serving.AsyncFrameEngine`` wires them together and adds the completion
watchdog; ``EngineStats`` counts ``failed`` / ``retries`` / ``fallbacks`` /
``carry_resets`` / ``shed`` / ``watchdog_trips``.
"""
from .errors import (
    AdmissionError,
    AllBackendsFailed,
    DeadlineExceeded,
    EngineClosed,
    EngineTimeout,
    InjectedFault,
    KernelBuildError,
    KernelLaunchError,
    NonFiniteOutput,
    ReliabilityError,
)
from .faults import FAULT_KINDS, Fault, FaultInjector, FaultPlan
from .guards import (
    DEFAULT_CARRY_LIMIT,
    DispatchGuard,
    carry_ok_rows,
    finite_rows,
    validate_frame,
)
from .retry import CircuitBreaker, GuardedDispatch, RetryPolicy

__all__ = [
    "ReliabilityError",
    "AdmissionError",
    "InjectedFault",
    "EngineTimeout",
    "DeadlineExceeded",
    "NonFiniteOutput",
    "AllBackendsFailed",
    "EngineClosed",
    "KernelBuildError",
    "KernelLaunchError",
    "Fault",
    "FaultPlan",
    "FaultInjector",
    "FAULT_KINDS",
    "DEFAULT_CARRY_LIMIT",
    "DispatchGuard",
    "validate_frame",
    "finite_rows",
    "carry_ok_rows",
    "RetryPolicy",
    "CircuitBreaker",
    "GuardedDispatch",
]
