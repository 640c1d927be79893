"""The port's examples (``python -m repro_torch.examples.<name>``), each
run through its ``main`` on the CPU at a tiny size: every act runs, the
checks each example prints hold, and importing a module runs nothing."""
import importlib

import numpy as np
import pytest

EXAMPLES = ("quickstart", "denoise_stream", "denoise_video", "denoise_fleet", "serve_lm", "vlm_preprocess",
            "train_lm")


@pytest.mark.parametrize("name", EXAMPLES)
def test_importing_an_example_runs_nothing(name, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert callable(mod.main)
    assert capsys.readouterr().out == ""


def test_quickstart(capsys):
    from repro_torch.examples import quickstart

    res = quickstart.main(["--device", "cpu", "--height", "48", "--width", "64", "--radii", "4,8",
                           "--reps", "1"])
    q = res["quality"]
    noisy = q["noisy input"][0]
    assert all(m > noisy for name, (m, _) in q.items() if name != "noisy input")
    # the fused kernel's plain version and the plan give the reference's image
    bg = q["BG (this paper)"]
    assert q["BG fused kernel (B1)"] == bg
    assert sorted(res["sweep"]) == [4, 8] and res["device"] == "cpu"
    assert "window-radius sweep" in capsys.readouterr().out


def test_denoise_stream():
    from repro_torch.examples import denoise_stream

    res = denoise_stream.main(["--device", "cpu", "--height", "40", "--width", "56", "--frames", "3"])
    assert len(res["max_diff_vs_reference"]) == 3
    assert max(res["max_diff_vs_reference"]) <= 1.0  # one quantization LSB at most
    assert res["looped_equal_batched"]


def test_denoise_video():
    from repro_torch.examples import denoise_video

    res = denoise_video.main(["--device", "cpu", "--height", "32", "--width", "48", "--frames", "3",
                              "--streams", "2"])
    assert res["alpha0_equal"]
    assert res["served"] == 6 and res["failed"] == 0
    assert set(res["static_psnr"]) == {0.0, 0.3, 0.6, 0.8}


def test_denoise_fleet():
    from repro_torch.examples import denoise_fleet

    res = denoise_fleet.main(["--device", "cpu", "--height", "32", "--width", "48", "--frames", "4",
                              "--workers", "3", "--streams", "6"])
    assert res["workers_alive"] == 2 and res["failed"] == 0
    assert res["completed"] == res["frames"]
    # every stream of the killed worker moved to a survivor
    assert sorted(s for s, _ in res["moved"]) == res["victim_streams"]
    assert all(w != res["victim"] for _, w in res["moved"])


def test_serve_lm(capsys):
    from repro_torch.examples import serve_lm

    res = serve_lm.main(["--device", "cpu", "--requests", "5", "--max-tokens", "4"])
    assert res["requests"] == 5 and res["tokens"] == 20
    assert all(len(g) == 4 for g in res["generated"])
    assert "5 requests / 20 tokens" in capsys.readouterr().out


def test_vlm_preprocess_gives_jax_logits():
    """With the JAX package's projection and parameters carried over
    (``proj=``, ``params=``; D1), the example's logits are JAX's for the
    same noisy images and tokens (rtol/atol 1e-4); denoising pulls the
    patch embeddings toward the clean ones; its denoised frames are the JAX
    plan's within the quantized contract (>= 99.5 % equal, <= 1 LSB)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import repro.configs.registry as JR
    import repro.data as JD
    import repro.models as JM
    import repro_torch.models as TM
    from repro.core import BGConfig
    from repro.plan import plan_for
    from repro_torch.examples import vlm_preprocess

    cfg = JR.get_smoke_config("llama-3.2-vision-11b")
    key = jax.random.PRNGKey(0)
    proj = np.array(jax.random.normal(key, (14 * 14, cfg.d_model), jnp.float32) * (1.0 / 14.0))
    jp = jax.jit(lambda k: JM.init_params(k, cfg))(key)
    res = vlm_preprocess.main(["--device", "cpu", "--size", "56"], proj=proj,
                              params=TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    assert res["finite"] and res["logits_shape"] == (2, 12, cfg.vocab_size)
    assert res["d_denoised"] < res["d_noisy"]
    noisy = jnp.asarray(res["noisy"].numpy())
    bg = BGConfig(r=4, sigma_s=3.0, sigma_r=50.0)
    jplan = plan_for(bg, 56, 56, n_frames=2)
    d = np.abs(res["denoised"].numpy() - np.asarray(JD.denoise_batch(noisy, plan=jplan)))
    assert (d == 0).mean() >= 0.995 and d.max() <= 1.0
    ctx = JD.vlm_preprocess(noisy, bg, 14, cfg.d_model, plan=jplan)
    n = cfg.cross_attn_tokens
    ctx = jnp.pad(ctx[:, :n], ((0, 0), (0, n - min(n, ctx.shape[1])), (0, 0)))
    np.testing.assert_allclose(res["ctx"].numpy(), np.asarray(ctx), rtol=1e-4, atol=1e-4)
    logits, _, _ = JM.forward(jp, cfg, tokens=jnp.asarray(res["tokens"].numpy()), cross_ctx=ctx, mode="train")
    np.testing.assert_allclose(res["logits"].numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)


def test_train_lm_config_is_the_jax_examples():
    """``LM100M`` and the options are the JAX example's
    (``examples/train_lm.py``, loaded from its file)."""
    import dataclasses
    import importlib.util
    import pathlib

    from repro_torch.examples import train_lm

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("jax_train_lm_example", path)
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    assert dataclasses.asdict(train_lm.LM100M) == dataclasses.asdict(jex.LM100M)
    assert train_lm.LM100M.param_count() == jex.LM100M.param_count()


def test_train_lm(tmp_path, capsys, monkeypatch):
    """The example at a tiny width on the CPU: 22 steps, then a rerun that
    resumes from its checkpoint."""
    import dataclasses
    import signal

    from repro_torch.examples import train_lm

    small = dataclasses.replace(train_lm.LM100M, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                                vocab_size=512, n_repeats=2)
    monkeypatch.setattr(train_lm, "LM100M", small)
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        argv = ["--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
        res = train_lm.main(argv + ["--steps", "22"])
        assert res["state"] == "initialized" and res["step"] == 22 and len(res["losses"]) == 22
        assert res["first10"] is not None and all(np.isfinite(res["losses"]))
        assert res["trainer"].ckpt.steps() == [22]
        again = train_lm.main(argv + ["--steps", "24"])
        assert again["state"] == "resumed" and again["step"] == 24 and again["first10"] is None
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)
    out = capsys.readouterr().out
    assert "state: initialized step 0" in out and "state: resumed step 22" in out and "loss: first10" in out
