"""The port's stripe pipeline (``repro_torch.core.streaming``, the
``"streaming"`` backend) against the JAX package's ``"streaming"`` and the
port's ``"reference"``, on the same numpy frames: atol 1e-3 unquantized
(tests/test_core_bg.py:99-113), the quantized contract (>= 99.5 % of pixels
equal, at most 1 LSB apart), both normalization modes, a height that is not
a multiple of r, and batches of 1 and 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.plan import BGPlan as JBGPlan
import repro_torch.core as T
from repro_torch.plan import BGPlan, plan_cost_breakdown, plan_for
from repro_torch.sharding import BatchMesh

ATOL = 1e-3


def noisy_np(shape, seed=3, sigma=30.0):
    """Synthetic scenes + numpy Gaussian noise, 8-bit quantized."""
    *b, h, w = shape
    clean = np.stack([T.synthetic_image_np(h, w, seed=seed + i) for i in range(int(np.prod(b)))])
    noise = np.random.default_rng(seed + 50).normal(0.0, sigma, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32).reshape(shape)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


def jax_streaming(frames, args, mode, quantize):
    jc = J.BGConfig(*args, normalize_mode=mode)
    return np.asarray(JBGPlan(cfg=jc, backend="streaming", quantize_output=quantize)(jnp.asarray(frames)))


def port(frames, args, mode, quantize, backend="streaming"):
    tc = T.BGConfig(*args, normalize_mode=mode)
    return BGPlan(tc, backend=backend, quantize_output=quantize, device="cpu")(frames).numpy()


@pytest.mark.parametrize("mode", ["paper", "classic"])
@pytest.mark.parametrize("r", [2, 5, 7, 12])
def test_streaming_matches_jax_and_reference(mode, r):
    x = noisy_np((40, 60))
    args = (r, 4.0, 50.0)
    mine = port(x, args, mode, False)
    assert mine.shape == x.shape and mine.dtype == np.float32
    np.testing.assert_allclose(mine, jax_streaming(x, args, mode, False), atol=ATOL)
    np.testing.assert_allclose(mine, port(x, args, mode, False, "reference"), atol=ATOL)
    quantized_contract(port(x, args, mode, True), jax_streaming(x, args, mode, True))


@pytest.mark.parametrize("mode", ["paper", "classic"])
@pytest.mark.parametrize("b", [1, 3])
def test_streaming_batch_with_a_ragged_height(b, mode):
    """h = 43 is a multiple of neither r = 7 nor r = 5 (the last stripe is
    padded and masked); each row of a batch equals its frame run alone, bit
    for bit (the batch steps through its stripes together)."""
    x = noisy_np((b, 43, 50), seed=11)
    for r in (5, 7):
        args = (r, 4.0, 50.0)
        mine = port(x, args, mode, False)
        assert mine.shape == x.shape
        np.testing.assert_allclose(mine, jax_streaming(x, args, mode, False), atol=ATOL)
        np.testing.assert_allclose(mine, port(x, args, mode, False, "reference"), atol=ATOL)
        for i in range(b):
            np.testing.assert_array_equal(mine[i], port(x[i], args, mode, False))


def test_streaming_out_of_range_input_follows_jax():
    """Inputs outside [0, 255] follow JAX's index rules: a negative z bin
    wraps once, the scatter drops what is still outside the grid and the
    gathers clamp (C1's rule for every backend)."""
    x = noisy_np((37, 48), seed=5)
    x[:6] = np.linspace(-60.0, 0.0, 6 * 48, dtype=np.float32).reshape(6, 48)
    x[-6:] = np.linspace(255.0, 330.0, 6 * 48, dtype=np.float32).reshape(6, 48)
    for mode in ("paper", "classic"):
        args = (6, 4.0, 60.0)
        np.testing.assert_allclose(
            port(x, args, mode, False), jax_streaming(x, args, mode, False), atol=ATOL
        )


def test_streaming_entry_point_and_plan_agree():
    x = noisy_np((2, 30, 41))
    cfg = T.BGConfig(4, 3.0, 50.0)
    plan = BGPlan(cfg, backend="streaming", device="cpu")
    out = T.bilateral_grid_filter_streaming(x, cfg, device="cpu")
    assert torch.equal(out, plan(x))
    assert torch.equal(T.bilateral_grid_filter_streaming(x, plan=plan), out)
    with pytest.raises(TypeError, match="cfg= or plan="):
        T.bilateral_grid_filter_streaming(x)


@pytest.mark.parametrize("kw", [dict(sharded=True), dict(mesh="batch")])
def test_streaming_mesh_raises_until_ported(kw):
    """Mesh sharding of the stripe pipeline is ported (the name is from
    before it was): as in the JAX package, ``sharded=True`` with no card to
    auto-mesh over is the one-device plan, a ``mesh`` without ``sharded`` is
    ignored, and over an explicit 3-handle mesh (a ragged split of 2
    frames) the output is the one-device output bit for bit, also through
    ``plan_for``."""
    cfg = T.BGConfig(4, 3.0, 50.0)
    x = noisy_np((2, 20, 24))
    want = BGPlan(cfg, backend="streaming", device="cpu")(x)
    assert torch.equal(T.bilateral_grid_filter_streaming(x, cfg, device="cpu", **kw), want)
    mesh = BatchMesh(("cpu",) * 3)
    meshed = T.bilateral_grid_filter_streaming(x, cfg, device="cpu", **dict(kw, sharded=True, mesh=mesh))
    assert torch.equal(meshed, want)
    if kw.get("sharded"):
        assert plan_for(cfg, 20, 24, backend="streaming", device="cpu", **kw).mesh is None
    else:
        with pytest.raises(TypeError, match="BatchMesh"):
            plan_for(cfg, 20, 24, backend="streaming", device="cpu", **kw)
    plan = plan_for(cfg, 20, 24, backend="streaming", device="cpu", mesh=mesh)
    assert (plan.mesh_size, plan.to_json()["mesh_size"]) == (3, 3)
    assert torch.equal(plan(x), want)


def test_streaming_plan_is_pinned_never_ranked():
    cfg = T.BGConfig(4, 3.0, 50.0)
    plan = plan_for(cfg, 20, 24, n_frames=4, backend="streaming", device="cpu")
    assert (plan.backend, plan.provenance, plan.batch_tile) == ("streaming", "explicit", None)
    jplan = JBGPlan(cfg=J.BGConfig(4, 3.0, 50.0), backend="streaming")
    assert plan.to_json() == jplan.to_json() and plan.plan_hash() == jplan.plan_hash()
    with pytest.raises(ValueError, match="never ranked"):
        plan_cost_breakdown(plan, 20, 24, 4)
    assert plan_for(cfg, 20, 24, n_frames=4, device="cpu").backend != "streaming"
