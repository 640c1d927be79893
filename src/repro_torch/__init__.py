"""PyTorch / CUDA port of the variable-window bilateral grid, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors it module
for module and never imports it or JAX. Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise.

Ported (the frame- and video-serving paths at full width):
  * ``core``: ``BGConfig`` and the whole-image GC / GF / TI, noise and the
    synthetic scenes, MSSIM / PSNR;
  * ``kernels``: the six kernels of the JAX package, hand-written CUDA,
    each beside its plain PyTorch version: the fused GC -> GF -> TI filter
    (``kernels/csrc/bg_fused.cu``) per frame (B1) and with the in-kernel
    temporal grid EMA (B2); the streamed fused filter
    (``csrc/bg_fused_streamed.cu``, B3, equal to B1 bit for bit); the
    staged GC, GF and TI (``csrc/bg_create.cu``, ``bg_blur.cu``,
    ``bg_slice.cu``, B4-B6); and ``bilateral_grid_filter_pallas``; B1, B2
    and B3 in both storage forms, fp32 and bf16;
  * ``plan``: ``BGPlan`` with the ``"reference"``, ``"fused"``,
    ``"fused_streamed"`` and ``"staged"`` backends, per frame and temporal,
    fp32 and (but ``"staged"``, as in the JAX package) bf16 storage, one
    device, JSON payloads and hashes shared with the JAX package; its
    fallback ladder, provenance and dispatch hook; ``plan_for`` on an H100
    cost model; ``plan_cache``, the measured-plan cache and its CLI;
  * ``video``: ``temporal_denoise``, ``blurred_grid_batch``,
    ``StreamSession`` and ``MultiStreamPacker`` (carry snapshots shared
    with the JAX package);
  * ``serving``: ``FrameDenoiseEngine`` and ``AsyncFrameEngine`` (futures,
    deadline micro-batching, pinned host-to-device feeding, output and
    carry guards, guarded dispatch: retries, the fallback ladder, the
    watchdog, fault injection); ``reliability``: the structured errors, the
    guards, retry and breakers, fault injection;
  * ``data.pipeline.denoise_batch``, ``data.synthetic_video``,
    ``configs.bg_denoise`` and ``launch.serve --frames`` (``--stream-input``)
    / ``--video``.

Not ported yet: the ``"streaming"`` backend (no kernel), mesh sharding,
the fleet (and with it the transport faults), and the LM substrate.
"""
