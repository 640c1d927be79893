"""PyTorch / CUDA port of the variable-window bilateral grid, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors it module
for module and never imports it or JAX. Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise.

Ported (the frame- and video-serving paths at full width):
  * ``core``: ``BGConfig`` and the whole-image GC / GF / TI, the stripe
    pipeline (``streaming``), the shift-only integer datapath
    (``fixed_point``), the exact bilateral filter and ``gaussian_blur``,
    noise and the synthetic scenes, MSSIM / PSNR;
  * ``kernels``: the six kernels of the JAX package, hand-written CUDA,
    each beside its plain PyTorch version: the fused GC -> GF -> TI filter
    (``kernels/csrc/bg_fused.cu``) per frame (B1) and with the in-kernel
    temporal grid EMA (B2); the streamed fused filter
    (``csrc/bg_fused_streamed.cu``, B3, equal to B1 bit for bit); the
    staged GC, GF and TI (``csrc/bg_create.cu``, ``bg_blur.cu``,
    ``bg_slice.cu``, B4-B6); and ``bilateral_grid_filter_pallas``; B1, B2
    and B3 in both storage forms, fp32 and bf16;
  * ``plan``: ``BGPlan`` with the ``"reference"``, ``"streaming"``,
    ``"fused"``, ``"fused_streamed"`` and ``"staged"`` backends, per frame
    and temporal,
    fp32 and (but ``"staged"``, as in the JAX package) bf16 storage, on one
    device or split over a batch mesh, JSON payloads and hashes shared with
    the JAX package; its
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
  * ``fleet``: the router (sticky streams, admission, backpressure,
    snapshot-restore failover, rolling restarts), the plan controller,
    health and stats, the wire codec (the JAX package's bytes, bf16 by
    name), thread-hosted and subprocess workers, and the transport faults
    (``FaultInjector.on_transport``);
  * ``data``: ``denoise_batch`` and the [vlm] / [audio] frontends
    (``patchify_embed``, ``vlm_preprocess``, ``spectrogram_denoise``),
    ``synthetic_video``, ``vision_context``, ``audio_frames``;
    ``configs.bg_denoise`` and ``launch.serve --frames`` (``--stream-input``)
    / ``--video`` (``--workers``, ``--worker-backend``);
  * ``sharding``: ``BatchMesh``, ``batch_mesh``, ``shard_batch_call``,
    ``bg_denoise_sharded`` and ``bg_temporal_sharded``: the frame and stream
    batch axis split over several devices (pad, split, dispatch per
    device, gather, trim; no collectives), through every entry point that
    takes a mesh in the JAX package;
  * ``examples``: ``quickstart``, ``denoise_stream``, ``denoise_video``,
    ``denoise_fleet``, ``serve_lm``, ``vlm_preprocess`` and ``train_lm``
    (``python -m repro_torch.examples.<name>``);
  * the LM serving substrate: ``configs`` (the ten archs, ``SHAPES``, the
    registry), ``models`` (layers, attention with its caches, MoE, the
    recurrent mixers, blocks, the pattern model, the stub frontends,
    ``params_from_jax`` / ``caches_from_jax``), ``serving.ServeEngine`` and
    the samplers, ``TokenStream`` / ``lm_batches``, and ``launch.serve
    --arch`` (``--ckpt-dir``): plain PyTorch, as the JAX package has no
    kernel there;
  * LM training and checkpoints: ``train`` (AdamW and its schedule, the
    train step with gradient accumulation, the model's remat, ``Trainer``,
    int8 gradient compression), ``checkpoint`` (the JAX package's on-disk
    layout, ``CheckpointManager``) and ``launch.train``: autograd over the
    LM forward, no kernel;
  * LM sharding: ``sharding.partitioning`` (logical-axis rules resolved to
    DTensor layouts over a ``DeviceMesh``), ``sharding.compat``
    (``shard_map``, the active mesh), ring attention, GPipe,
    ``checkpoint.elastic`` and ``launch.train --mesh --distributed``;
  * the dry-run and roofline tooling: ``launch.specs`` (meta-tensor input
    specs), ``launch.dryrun`` (each arch x shape x mesh cell's step run once
    on meta tensors as rank 0 of a fake process group of 256 or 512 ranks,
    touching no card), ``launch.hlo_cost`` / ``launch.hlo_analysis`` (the
    step's FLOPs, HBM bytes and collectives counted op by op, the roofline
    terms at the H100's peaks) and ``launch.roofline`` (the tables).

Nothing of the JAX package is left to port.
"""
