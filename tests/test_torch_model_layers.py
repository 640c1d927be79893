"""The port's LM layers (``repro_torch.models``: layers, attention, MoE,
recurrent mixers, caches, frontends) against the JAX package's, on the CPU
with the same numpy inputs and the JAX parameters carried over. The whole
models, arch by arch, are in ``test_torch_models.py``. Tolerances: rtol
1e-4 / atol 1e-4 in fp32; the blocked attention path against the plain one
atol 2e-5 and the chunkwise mLSTM against the parallel form rtol/atol 1e-4
(the JAX package's ``tests/test_long_context_paths.py:36,62``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as JB
import repro.configs.registry as JR
import repro.models as JM
import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.moe as JMOE
import repro.models.recurrent as JREC
import repro_torch.configs.base as TB
import repro_torch.configs.registry as TR
import repro_torch.models as TM
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
import repro_torch.models.moe as TMOE
import repro_torch.models.recurrent as TREC
from repro.models.frontends import make_audio_inputs as j_audio
from repro.models.frontends import make_vision_inputs as j_vision
from repro_torch.models.frontends import (input_specs_audio_embeds, input_specs_vision_ctx,
                                          make_audio_inputs, make_vision_inputs)

RTOL = ATOL = 1e-4


def assert_tree_close(mine, theirs, rtol=RTOL, atol=ATOL, path=""):
    if isinstance(theirs, dict):
        assert set(mine) == set(theirs), (path, sorted(mine), sorted(theirs))
        for k in theirs:
            assert_tree_close(mine[k], theirs[k], rtol, atol, f"{path}/{k}")
        return
    m = mine.detach().to(torch.float64).numpy() if isinstance(mine, torch.Tensor) else mine
    t = np.asarray(theirs).astype(np.float64)
    assert m.shape == t.shape, (path, m.shape, t.shape)
    np.testing.assert_allclose(m, t, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("dispatch", ["ragged", "einsum"])
def test_moe_dispatch_matches_jax(dispatch):
    """Both MoE dispatch paths of qwen2-moe (top-2 of 8) against JAX's, at a
    capacity that drops tokens on the einsum path."""
    jcfg = JR.get_smoke_config("qwen2-moe-a2.7b")
    spec = dataclasses.replace(jcfg.pattern[0].moe, dispatch=dispatch, capacity_factor=0.75)
    jspec = JB.MoESpec(**dataclasses.asdict(spec))
    tspec = TB.MoESpec(**dataclasses.asdict(spec))
    jm = jax.jit(lambda k: JMOE.init_moe(k, jcfg, jspec))(jax.random.PRNGKey(5))
    x = np.random.default_rng(6).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_ffn(p, x, jcfg, jspec))(jm, jnp.asarray(x))
    tm = TM.params_from_jax(jax.tree.map(np.asarray, jm), device="cpu")
    ty, taux = TMOE.moe_ffn(tm, torch.from_numpy(x), TR.get_smoke_config("qwen2-moe-a2.7b"), tspec)
    assert_tree_close(ty, jy)
    assert_tree_close(taux, jaux)


def test_router_top_k_ties_break_to_the_lower_expert():
    """All router probabilities equal: JAX's ``top_k`` picks experts 0..k-1,
    and so does the port."""
    cfg = TR.get_smoke_config("qwen2-moe-a2.7b")
    spec = cfg.pattern[0].moe
    params = {"router": {"kernel": torch.zeros((cfg.d_model, spec.num_experts))}}
    x = torch.randn(3, 5, cfg.d_model)
    gates, idx, _ = TMOE._router(params, x, spec)
    jg, jidx, _ = JMOE._router({"router": {"kernel": jnp.zeros((cfg.d_model, spec.num_experts))}},
                               jnp.asarray(x.numpy()), JB.MoESpec(**dataclasses.asdict(spec)))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == list(range(spec.top_k))
    assert_tree_close(gates, jg)


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_p1", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(32).astype(np.float32)
    mine = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), kind)
    assert_tree_close(mine, JL.apply_norm(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_matches_jax(fraction):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    c, s, rot = TL.rope_angles(torch.from_numpy(pos), 16, 5e6, fraction)
    jc, js, jrot = JL.rope_angles(jnp.asarray(pos), 16, 5e6, fraction)
    assert rot == jrot
    assert_tree_close(TL.apply_rope(torch.from_numpy(x), c, s, rot), JL.apply_rope(jnp.asarray(x), jc, js, jrot))


def test_dense_bias_gelu_and_loss_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    p = {"kernel": rng.standard_normal((8, 4, 5)).astype(np.float32),
         "bias": rng.standard_normal((4, 5)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert_tree_close(TL.dense(tp, torch.from_numpy(x)), JL.dense(p, jnp.asarray(x)))
    assert_tree_close(TL.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)))
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        mine = TL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if m is None else torch.from_numpy(m))
        assert_tree_close(mine, JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                                      None if m is None else jnp.asarray(m)))


def test_fully_masked_row_is_uniform_not_nan():
    """A query whose every key slot is empty (pos -1) gets NEG_INF logits
    everywhere: a uniform softmax over the values, as in JAX."""
    q = torch.randn(1, 1, 2, 4)
    k = torch.randn(1, 3, 1, 4)
    v = torch.randn(1, 3, 1, 4)
    qpos = torch.zeros((1, 1), dtype=torch.int32)
    kpos = torch.full((1, 3), -1, dtype=torch.int32)
    out = TA._sdpa_plain(q, k, v, qpos, kpos, TB.AttnSpec(), 0.0)
    assert torch.allclose(out[0, 0, 0], v[0, :, 0].mean(0), atol=1e-6)
    assert torch.allclose(out[0, 0, 1], v[0, :, 0].mean(0), atol=1e-6)


# ------------------------------------------------- long-context paths
def _qkv(seed, b=2, s=256, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return q, k, v, pos


SPECS = [dict(kind="global"), dict(kind="global", causal=False), dict(kind="local", window=64),
         dict(kind="chunked", chunk=64)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(f"{k}={v}" for k, v in s.items()))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_blocked_sdpa_matches_plain_and_jax(spec, softcap):
    arrays = _qkv(0)
    q, k, v, pos = (torch.from_numpy(a) for a in arrays)
    tspec = TB.AttnSpec(**spec)
    plain = TA._sdpa_plain(q, k, v, pos, pos, tspec, softcap)
    blocked = TA._sdpa_blocked(q, k, v, pos, pos, tspec, softcap, q_block=32, kv_block=64)
    np.testing.assert_allclose(blocked.numpy(), plain.numpy(), atol=2e-5)
    jq, jk, jv, jpos = (jnp.asarray(a) for a in arrays)
    theirs = JA._sdpa_blocked(jq, jk, jv, jpos, jpos, JB.AttnSpec(**spec), softcap, q_block=32, kv_block=64)
    np.testing.assert_allclose(blocked.numpy(), np.asarray(theirs), atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(JA._sdpa_plain(jq, jk, jv, jpos, jpos,
                                                                          JB.AttnSpec(**spec), softcap)),
                               atol=2e-5)


def test_sdpa_dispatches_long_sequences_to_the_blocked_path(monkeypatch):
    seen = []
    monkeypatch.setattr(TA, "FLASH_MIN_SEQ", 128)
    monkeypatch.setattr(TA, "FLASH_Q_BLOCK", 64)
    monkeypatch.setattr(TA, "_sdpa_blocked", lambda *a: seen.append(a[0].shape) or TA._sdpa_plain(*a))
    q, k, v, pos = (torch.from_numpy(a) for a in _qkv(1, s=128))
    TA._sdpa(q, k, v, pos, pos, TB.AttnSpec(), 0.0)
    assert seen == [q.shape]


def _gates(seed, b=2, s=256, h=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, d)) / np.sqrt(d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.standard_normal((b, s, h)) + 2.0, jnp.float32)))
    return q, k, v, li, lf


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_chunkwise_mlstm_matches_parallel_and_jax(chunk):
    arrays = _gates(2)
    t = [torch.from_numpy(a) for a in arrays]
    par = TREC._mlstm_parallel(*t)
    out, (C, n, m) = TREC._mlstm_chunkwise(*t, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), par.numpy(), rtol=1e-4, atol=1e-4)
    j = [jnp.asarray(a) for a in arrays]
    jout, (jC, jn, jm) = JREC._mlstm_chunkwise(*j, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(par.numpy(), np.asarray(JREC._mlstm_parallel(*j)), rtol=1e-4, atol=1e-4)
    assert_tree_close({"C": C, "n": n, "m": m}, {"C": jC, "n": jn, "m": jm}, rtol=1e-3, atol=1e-3)


def test_rglru_scan_matches_jax_associative_scan():
    """The sequential loop against ``jax.lax.associative_scan`` (another
    order of the same products), with and without an initial state."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.999, (2, 64, 16)).astype(np.float32)
    b = rng.standard_normal((2, 64, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    for init in (None, h0):
        mine = TREC._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                None if init is None else torch.from_numpy(init))
        theirs = jax.jit(JREC._rglru_scan)(jnp.asarray(a), jnp.asarray(b),
                                           None if init is None else jnp.asarray(init))
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)


def test_splice_cache_matches_jax():
    cfg = JR.get_smoke_config("recurrentgemma-9b")  # pattern and tail leaves
    batched = JM.init_caches(cfg, 3, 16)
    rng = np.random.default_rng(10)
    single = jax.tree.map(lambda t: jnp.asarray(rng.standard_normal(t.shape)).astype(t.dtype),
                          JM.init_caches(cfg, 1, 16))
    theirs = jax.jit(JM.splice_cache, static_argnums=2)(batched, single, 1)
    mine = TM.splice_cache(TM.caches_from_jax(jax.tree.map(np.asarray, batched), device="cpu"),
                           TM.caches_from_jax(jax.tree.map(np.asarray, single), device="cpu"), 1)
    assert_tree_close(mine, jax.tree.map(np.asarray, theirs), rtol=0, atol=0)


def test_frontends_match_jax():
    vcfg = TR.get_smoke_config("llama-3.2-vision-11b")
    acfg = TR.get_smoke_config("hubert-xlarge")
    assert np.array_equal(make_vision_inputs(vcfg, 2, seed=3, device="cpu").numpy(),
                          np.asarray(j_vision(JR.get_smoke_config("llama-3.2-vision-11b"), 2, seed=3)))
    assert np.array_equal(make_audio_inputs(acfg, 2, 9, seed=4, device="cpu").numpy(),
                          np.asarray(j_audio(JR.get_smoke_config("hubert-xlarge"), 2, 9, seed=4)))
    spec = input_specs_vision_ctx(vcfg, 4)
    assert spec.shape == (4, 17, 128) and spec.dtype == torch.bfloat16 and spec.is_meta
    assert input_specs_audio_embeds(acfg, 2, 9).shape == (2, 9, 64)
    with pytest.raises(ValueError):
        input_specs_audio_embeds(vcfg, 2, 9)


def test_entry_points_want_the_card_unless_told():
    """No quiet move to the CPU: without a card and without ``device="cpu"``
    the model's entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = TR.get_smoke_config("yi-6b")
    for call in (lambda: TM.init_params(0, cfg), lambda: TM.init_caches(cfg, 1, 8),
                 lambda: TM.params_from_jax({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
