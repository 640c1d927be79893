"""Public entry points for the kernel-backed bilateral-grid pipeline.

``bilateral_grid_filter_pallas`` keeps the JAX package's name and signature
so a reader can find its counterpart; in the port it runs a
:class:`repro_torch.plan.BGPlan`. ``fused=True`` maps to the fused kernel
(``"fused"``, or ``"fused_streamed"`` with ``stream_input=True``),
``fused=False`` to the three staged kernels (``"staged"``: GC, GF and TI
with the grid in HBM between them), as ``repro/kernels/ops.py`` maps them.
"""
from __future__ import annotations

from repro_torch.core.bilateral_grid import BGConfig, grid_normalize

from .bg_blur import bg_blur, bg_blur_plain
from .bg_create import bg_create, bg_create_plain
from .bg_fused import bg_fused, bg_fused_plain
from .bg_slice import bg_slice, bg_slice_plain

__all__ = [
    "bg_create",
    "bg_create_plain",
    "bg_blur",
    "bg_blur_plain",
    "bg_slice",
    "bg_slice_plain",
    "bg_fused",
    "bg_fused_plain",
    "bilateral_grid_filter_pallas",
]


def _staged_single(image, cfg: BGConfig):
    """The staged pipeline on a (h, w) frame or a (b, h, w) batch: GC (B4),
    GF (B5), the eq. (4) normalization as a torch expression (the JAX
    package computes it outside any kernel too), TI (B6). On the card, one
    launch of each kernel for the whole batch."""
    blurred = bg_blur(bg_create(image, cfg), cfg)
    return bg_slice(grid_normalize(blurred), image, cfg)


def bilateral_grid_filter_pallas(
    image,
    cfg: BGConfig | None = None,
    fused: bool = True,
    quantize_output: bool = True,
    batch_tile: int | None = None,
    stream_input: bool = False,
    *,
    plan=None,
    device=None,
):
    """Kernel-backed BG pipeline (paper normalization) on a (h, w) frame, a
    (b, h, w) batch or a (b, h, w, c) color batch.

    Preferred form: ``bilateral_grid_filter_pallas(image, plan=plan)``. The
    keyword form builds the equivalent plan, as the JAX package does:
    ``fused`` picks the fused (``stream_input``: streamed) or the staged
    backend, with ``batch_tile`` and ``quantize_output``, on ``device``
    (``None``: the CUDA card; ``"cpu"``: the plain versions). See
    :meth:`repro_torch.plan.BGPlan.__call__`.
    """
    from repro_torch.plan import BGPlan

    if plan is None:
        if cfg is None:
            raise TypeError("bilateral_grid_filter_pallas needs cfg= or plan=")
        backend = ("fused_streamed" if stream_input else "fused") if fused else "staged"
        plan = BGPlan(
            cfg=cfg,
            backend=backend,
            batch_tile=batch_tile,
            quantize_output=quantize_output,
            device=device,
        )
    elif device is not None:
        raise ValueError("pass device= with cfg=; a plan carries its own device")
    return plan(image)
