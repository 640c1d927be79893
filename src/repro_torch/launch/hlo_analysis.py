"""Collective statistics and the three roofline terms of a counted step: the
port of the JAX package's ``repro/launch/hlo_analysis.py``.

The counts come from :func:`repro_torch.launch.hlo_cost.analyze_step` (an
eager step run under a counting mode), not from HLO text, which the port
does not have. The hardware is one NVIDIA H100 SXM (per card):

* 989e12 FLOP/s, the dense bf16 peak of its tensor cores;
* 3.35e12 B/s of HBM3;
* 450e9 B/s each way over NVLink to the host's other cards, the rate
  every collective is charged at.

The NVLink rate holds within one host. A 16x16 or 2x16x16
mesh spans many hosts, whose collectives cross the network between them;
the repo has no source for that rate, so ``collective_s`` is the time the
traffic would take over NVLink, a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .hlo_cost import HloCost

__all__ = [
    "HW",
    "collective_stats",
    "roofline_terms",
    "Roofline",
]

PEAK_FLOPS = 989e12  # bf16 dense / card
HBM_BW = 3.35e12  # B/s / card
NVLINK_BW = 450e9  # B/s / card, each way
HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW}


def collective_stats(cost: HloCost) -> Dict[str, dict]:
    """Per-kind ``{count, bytes}`` of a counted step, bytes on the ring
    model (``hlo_cost``'s docstring), per rank."""
    return {k: {"count": v["count"], "bytes": v["bytes"]} for k, v in cost.collectives.items()}


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collective_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def roofline_terms(cost: HloCost) -> Roofline:
    """The three terms of one rank's step: compute = FLOPs / peak, memory =
    HBM bytes / HBM rate, collective = ring-model bytes / NVLink rate
    (every figure per card, as the counted step is one rank's)."""
    return Roofline(
        flops_per_chip=cost.flops,
        hbm_bytes_per_chip=cost.hbm_bytes,
        collective_bytes_per_chip=cost.collective_bytes,
        collective_breakdown=collective_stats(cost),
        compute_s=cost.flops / PEAK_FLOPS,
        memory_s=cost.hbm_bytes / HBM_BW,
        collective_s=cost.collective_bytes / NVLINK_BW,
    )
