"""PyTorch / CUDA port of the variable-window bilateral grid, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors it module
for module and never imports it or JAX. Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise.

Ported (the frame-serving path at full width):
  * ``core``: ``BGConfig`` and the whole-image GC / GF / TI, noise and the
    synthetic scenes, MSSIM / PSNR;
  * ``kernels``: the fused GC -> GF -> TI filter as a hand-written CUDA
    kernel (``kernels/csrc/bg_fused.cu``, replacing the JAX package's
    per-frame fused Pallas kernel) beside its plain PyTorch version, and
    ``bilateral_grid_filter_pallas(plan=)``;
  * ``plan``: ``BGPlan`` with the ``"reference"`` and ``"fused"`` backends,
    fp32, one device, JSON payloads shared with the JAX package;
  * ``data.pipeline.denoise_batch``, ``serving.FrameDenoiseEngine``,
    ``configs.bg_denoise`` and ``launch.serve --frames``.

Not ported yet: the temporal (video) kernel with ``video/`` and the async
engine, the ``"fused_streamed"``, ``"staged"`` and ``"streaming"`` backends
and their kernels, bf16 storage, plan tuning and the plan cache, mesh
sharding, reliability, the fleet, and the LM substrate.
"""
