"""Serving reliability, the part the async engine needs: structured errors,
admission checks and the post-dispatch finite-guards. Retries, the fallback
ladder, the watchdog and fault injection are not ported yet."""
from .errors import (
    AdmissionError,
    DeadlineExceeded,
    EngineClosed,
    EngineTimeout,
    NonFiniteOutput,
    ReliabilityError,
)
from .guards import (
    DEFAULT_CARRY_LIMIT,
    DispatchGuard,
    carry_ok_rows,
    finite_rows,
    validate_frame,
)

__all__ = [
    "AdmissionError",
    "DeadlineExceeded",
    "EngineClosed",
    "EngineTimeout",
    "NonFiniteOutput",
    "ReliabilityError",
    "DEFAULT_CARRY_LIMIT",
    "DispatchGuard",
    "carry_ok_rows",
    "finite_rows",
    "validate_frame",
]
