"""The paper's own workload config: full-HD 8-bit grayscale denoising.

Presets match the paper's evaluation settings (Table I / Table II / Fig. 12).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.bilateral_grid import BGConfig

__all__ = ["BGWorkload", "PAPER_DEFAULT", "TABLE1_SWEEP", "FIG12_SWEEPS", "SERVE_CONFIG"]


@dataclasses.dataclass(frozen=True)
class BGWorkload:
    name: str
    height: int
    width: int
    bg: BGConfig
    noise_sigma: float = 30.0


# Table II column "Our design": 1920x1080, r=12, sigma_r=70, sigma_s=8
PAPER_DEFAULT = BGWorkload(
    name="fullhd-r12",
    height=1080,
    width=1920,
    bg=BGConfig(r=12, sigma_s=8.0, sigma_r=70.0),
)

# Table I: r in {4, 8, 12, 16} at sigma_r=70, sigma_s=8
TABLE1_SWEEP = tuple(
    BGWorkload(
        name=f"fullhd-r{r}",
        height=1080,
        width=1920,
        bg=BGConfig(r=r, sigma_s=8.0, sigma_r=70.0),
    )
    for r in (4, 8, 12, 16)
)

# Fig. 12 sweeps: (a) r | (sigma_s, sigma_r)=(4,50); (b) sigma_s | (r,sigma_r)=(7,50);
# (c) sigma_r | (r,sigma_s)=(7,4)
FIG12_SWEEPS = {
    "r": tuple(
        BGConfig(r=r, sigma_s=4.0, sigma_r=50.0) for r in (2, 3, 5, 7, 9, 12, 16)
    ),
    "sigma_s": tuple(
        BGConfig(r=7, sigma_s=s, sigma_r=50.0) for s in (1.0, 2.0, 4.0, 8.0, 16.0)
    ),
    "sigma_r": tuple(
        BGConfig(r=7, sigma_s=4.0, sigma_r=s) for s in (10.0, 30.0, 50.0, 70.0, 100.0)
    ),
}

# the grid the JAX package's frame launcher serves (repro/launch/serve.py)
SERVE_CONFIG = BGConfig(r=6, sigma_s=4.0, sigma_r=60.0)
