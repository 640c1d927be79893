"""Public entry point for the kernel-backed bilateral-grid pipeline.

``bilateral_grid_filter_pallas`` keeps the JAX package's name so a reader can
find its counterpart; in the port it runs a :class:`repro_torch.plan.BGPlan`
(the ``plan=`` form only), whose ``"fused"`` backend is the CUDA kernel.
"""
from __future__ import annotations

from .bg_fused import bg_fused, bg_fused_plain

__all__ = ["bg_fused", "bg_fused_plain", "bilateral_grid_filter_pallas"]


def bilateral_grid_filter_pallas(image, *, plan):
    """Run ``plan`` on a (h, w) frame, a (b, h, w) batch or a (b, h, w, c)
    color batch; see :meth:`repro_torch.plan.BGPlan.__call__`."""
    return plan(image)
