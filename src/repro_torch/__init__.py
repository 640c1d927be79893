"""PyTorch / CUDA port of the variable-window bilateral grid, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors it module
for module and never imports it or JAX. Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise.

Ported (the frame- and video-serving paths at full width):
  * ``core``: ``BGConfig`` and the whole-image GC / GF / TI, noise and the
    synthetic scenes, MSSIM / PSNR;
  * ``kernels``: the fused GC -> GF -> TI filter as one hand-written CUDA
    source (``kernels/csrc/bg_fused.cu``) with two launches, per frame (B1)
    and with the in-kernel temporal grid EMA (B2), replacing the JAX
    package's fused Pallas kernel in both forms, beside its plain PyTorch
    version; and ``bilateral_grid_filter_pallas(plan=)``;
  * ``plan``: ``BGPlan`` with the ``"reference"`` and ``"fused"`` backends,
    per frame and temporal, fp32, one device, JSON payloads shared with the
    JAX package;
  * ``video``: ``temporal_denoise``, ``blurred_grid_batch``,
    ``StreamSession`` and ``MultiStreamPacker`` (carry snapshots shared
    with the JAX package);
  * ``serving``: ``FrameDenoiseEngine`` and ``AsyncFrameEngine`` (futures,
    deadline micro-batching, pinned host-to-device feeding, output and
    carry guards); ``reliability``: the structured errors and the guards;
  * ``data.pipeline.denoise_batch``, ``data.synthetic_video``,
    ``configs.bg_denoise`` and ``launch.serve --frames`` / ``--video``.

Not ported yet: the ``"fused_streamed"``, ``"staged"`` and ``"streaming"``
backends and their kernels (B3-B6), bf16 storage, plan tuning and the plan
cache, mesh sharding, the rest of reliability (retries, the fallback
ladder, the watchdog, fault injection), the fleet, and the LM substrate.
"""
