"""The port's data pipeline and stub modality inputs (``repro_torch.data``)
against the JAX package's (``repro.data``), on the same numpy inputs.

``vision_context`` and ``audio_frames`` are numpy in both packages: bit for
bit. The frontends denoise through a plan: the reference plan's quantized
output holds the quantized contract (>= 99.5 % of pixels equal, at most 1
LSB apart), and the embeddings agree within atol 1e-4 when JAX's projection
is carried across as a numpy array (``proj=``): the port draws its default
projection from a torch generator, a divergence on purpose."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data as JD
import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.plan import BGPlan
from repro_torch.sharding import BatchMesh

CFG = T.BGConfig(4, 3.0, 50.0)
JCFG = J.BGConfig(4, 3.0, 50.0)


def noisy_np(shape, seed=3, sigma=30.0):
    *b, h, w = shape
    clean = np.stack([T.synthetic_image_np(h, w, seed=seed + i) for i in range(int(np.prod(b)))])
    noise = np.random.default_rng(seed + 50).normal(0.0, sigma, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32).reshape(shape)


def quantized_contract(a, b, lsb=1.0):
    """The quantized contract in units of ``lsb`` (a rescaled output's one
    intensity level), with float round-off below 1e-3 of a level."""
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / lsb
    assert np.mean(diff <= 1e-3) >= 0.995, np.mean(diff <= 1e-3)
    assert diff.max() <= 1.0 + 1e-3


def jax_projection(patch, dim, seed=0):
    """The JAX package's patch projection (``repro/data/pipeline.py``), as a
    numpy array the port takes through ``proj=``."""
    key = jax.random.PRNGKey(seed)
    proj = jax.random.normal(key, (patch * patch, dim), jnp.float32) * (1.0 / np.sqrt(patch * patch))
    return np.array(proj)


@pytest.mark.parametrize("args", [(2, 5, 8, 0), (3, 7, 4, 11)])
def test_stub_modality_inputs_bit_equal(args):
    np.testing.assert_array_equal(TD.vision_context(*args), JD.vision_context(*args))
    np.testing.assert_array_equal(TD.audio_frames(*args), JD.audio_frames(*args))
    assert TD.vision_context(*args).dtype == TD.audio_frames(*args).dtype == np.float32


@pytest.mark.parametrize("patch,dim", [(8, 16), (5, 12)])
def test_patchify_embed_with_jax_projection(patch, dim):
    x = noisy_np((2, 43, 61))  # ragged against the patch: the remainder is cut
    theirs = np.asarray(JD.patchify_embed(jnp.asarray(x), patch, dim, seed=3))
    mine = TD.patchify_embed(x, patch, dim, proj=jax_projection(patch, dim, 3), device="cpu")
    assert mine.shape == theirs.shape == (2, (43 // patch) * (61 // patch), dim)
    np.testing.assert_allclose(mine.numpy(), theirs, atol=1e-4)


def test_default_projection_is_seeded_and_device_independent():
    """The default projection: standard normal numbers from a CPU generator
    seeded with ``seed``, over the patch size; not JAX's matrix."""
    a = torch.randn((16, 6), generator=torch.Generator().manual_seed(1)) / 4.0
    x = noisy_np((1, 8, 8))
    mine = TD.patchify_embed(x, 4, 6, seed=1, device="cpu")
    assert torch.equal(mine, TD.patchify_embed(x, 4, 6, proj=a, device="cpu"))
    assert not torch.equal(mine, TD.patchify_embed(x, 4, 6, seed=2, device="cpu"))
    # the divergence on purpose: the same seed is not JAX's matrix
    assert not np.allclose(a.numpy(), jax_projection(4, 6, 1))


@pytest.mark.parametrize("kwargs,backend", [
    (dict(), "reference"),
    (dict(stream_input=True), "reference"),
    (dict(use_kernels=True), "fused"),
    (dict(use_kernels=True, stream_input=True), "fused_streamed"),
])
def test_denoise_batch_legacy_keywords(kwargs, backend):
    """``cfg=`` alone is the reference plan, ``use_kernels`` the fused one,
    with ``stream_input`` the streamed one, as in the JAX package."""
    x = noisy_np((3, 30, 41))
    mine = TD.denoise_batch(x, CFG, device="cpu", **kwargs)
    assert torch.equal(mine, BGPlan(CFG, backend=backend, device="cpu")(x))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # JAX's legacy-keyword notice
        theirs = np.asarray(JD.denoise_batch(jnp.asarray(x), JCFG, **kwargs))
    quantized_contract(mine.numpy(), theirs)


@pytest.mark.parametrize("kw", [dict(sharded=True), dict(mesh="batch"), dict(use_kernels=True, sharded=True)])
def test_denoise_batch_mesh_raises_until_ported(kw):
    """Mesh sharding is ported (the name is from before it was): as in the
    JAX package, ``sharded=True`` is the fused plan, on one device when
    there is no card to auto-mesh over and over an explicit mesh bit for bit
    the same, and a ``mesh`` without ``sharded`` is ignored (the reference
    plan); ``vlm_preprocess`` forwards both, and each output holds the
    quantized contract against the JAX function's."""
    x = noisy_np((3, 20, 24))
    want = BGPlan(CFG, backend="fused" if kw.get("sharded") else "reference", device="cpu")(x)
    assert torch.equal(TD.denoise_batch(x, CFG, device="cpu", **kw), want)
    if kw.get("sharded"):
        meshed = TD.denoise_batch(x, CFG, device="cpu", **dict(kw, mesh=BatchMesh(("cpu",) * 2)))
        assert torch.equal(meshed, want)
    emb = TD.vlm_preprocess(x, CFG, 4, 8, device="cpu", **kw)
    assert torch.equal(emb, TD.patchify_embed(want, 4, 8, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # JAX's legacy-keyword notice
        theirs = np.asarray(JD.denoise_batch(jnp.asarray(x), JCFG, **kw))
    quantized_contract(want.numpy(), theirs)


def test_denoise_batch_needs_cfg_or_plan():
    with pytest.raises(TypeError, match="cfg= or plan="):
        TD.denoise_batch(noisy_np((1, 8, 8)))


@pytest.mark.parametrize("use_plan", [False, True])
def test_vlm_preprocess_matches_jax(use_plan):
    x = noisy_np((3, 40, 56), seed=21)
    patch, dim = 8, 16
    proj = jax_projection(patch, dim)
    plan = BGPlan(CFG, backend="reference", device="cpu") if use_plan else None
    mine = TD.vlm_preprocess(x, None if use_plan else CFG, patch, dim, plan=plan, proj=proj,
                             device=None if use_plan else "cpu")
    theirs = np.asarray(JD.vlm_preprocess(jnp.asarray(x), JCFG, patch, dim))
    assert mine.shape == theirs.shape == (3, 5 * 7, dim)
    # the denoised frames hold the quantized contract; the embedding of the
    # port's frames equals JAX's embedding of them within atol 1e-4
    den = TD.denoise_batch(x, CFG, device="cpu")
    quantized_contract(den.numpy(), np.asarray(JD.denoise_batch(jnp.asarray(x), JCFG)))
    np.testing.assert_allclose(
        mine.numpy(), np.asarray(JD.patchify_embed(jnp.asarray(den.numpy()), patch, dim)), atol=1e-4
    )
    # without denoising the two frontends agree directly
    raw = TD.vlm_preprocess(x, CFG, patch, dim, denoise=False, proj=proj, device="cpu")
    np.testing.assert_allclose(
        raw.numpy(), np.asarray(JD.vlm_preprocess(jnp.asarray(x), JCFG, patch, dim, denoise=False)),
        atol=1e-4,
    )


def test_spectrogram_reference_matches_jax_at_bin_edges():
    """An 8-bit picture mapped to dB: the frontend's min-max scaling gives
    values a few ulps from the integers, some just below a z-bin edge. The
    reference plans of both packages divide by the range scale and bin
    them alike, and so does the fused plan (ROADMAP C4)."""
    spec = noisy_np((2, 64, 96), seed=31) / 255.0 * 80.0 - 80.0
    mine = TD.spectrogram_denoise(spec, device="cpu")
    theirs = np.asarray(JD.spectrogram_denoise(jnp.asarray(spec)))
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=1e-4)
    fused = TD.spectrogram_denoise(spec, plan=BGPlan(T.BGConfig(4, 2.0, 40.0), device="cpu"))
    quantized_contract(fused.numpy(), theirs, lsb=(spec.max() - spec.min()) / 255.0)


def test_spectrogram_denoise_matches_jax():
    rng = np.random.default_rng(4)
    t = np.arange(48)[None, :, None] / 9.0
    f = np.arange(40)[None, None, :] / 7.0
    spec = (-60.0 + 30.0 * np.sin(t + f * rng.random((2, 1, 1))) + rng.normal(0.0, 6.0, (2, 48, 40)))
    spec = spec.astype(np.float32)
    mine = TD.spectrogram_denoise(spec, device="cpu")
    theirs = np.asarray(JD.spectrogram_denoise(jnp.asarray(spec)))
    assert mine.shape == spec.shape and mine.dtype == torch.float32
    lsb = (spec.max() - spec.min()) / 255.0
    quantized_contract(mine.numpy(), theirs, lsb=lsb)
    # the default grid is the JAX package's BGConfig(4, 2.0, 40.0)
    assert torch.equal(mine, TD.spectrogram_denoise(spec, T.BGConfig(4, 2.0, 40.0), device="cpu"))
    plan = BGPlan(T.BGConfig(4, 2.0, 40.0), backend="reference", device="cpu")
    assert torch.equal(mine, TD.spectrogram_denoise(spec, plan=plan))


@pytest.mark.parametrize("args", [(256, 0, 0.05), (50304, 7, 0.3)])
def test_token_stream_bit_equal(args):
    vocab, seed, noise = args
    mine, theirs = TD.TokenStream(vocab, seed, noise), JD.TokenStream(vocab, seed, noise)
    for shape in ((3, 17), (1, 5)):
        a, b = mine.sample(*shape), theirs.sample(*shape)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_lm_batches_bit_equal():
    got = list(TD.lm_batches(300, 2, 9, steps=3, seed=4))
    want = list(JD.lm_batches(300, 2, 9, steps=3, seed=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        assert all(np.array_equal(g[k], w[k]) for k in g)
        assert np.array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])
