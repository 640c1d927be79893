"""The port's LM model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU at each arch's smoke config.

The JAX parameters come across with ``params_from_jax`` and both packages
get the same numpy inputs. Each arch's JAX outputs (train logits and aux,
prefill logits and caches, one decode step) are computed once, under
``jax.jit``, and held in a module-scoped fixture. Tolerances: fp32 logits,
aux and cache leaves rtol 1e-4 / atol 1e-4; prefill + decode against the
train forward 5e-2 (``tests/test_arch_smoke.py:103``). The layers one by
one are in ``test_torch_model_layers.py``.
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
import repro_torch.configs.base as TB
import repro_torch.configs.registry as TR
import repro_torch.models as TM

RTOL = ATOL = 1e-4
B, S, MAX_LEN = 2, 16, 64
DECODERS = [a for a in JR.ARCHS if a != "hubert-xlarge"]


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


def inputs_np(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend == "audio":
        kw["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "vision":
        kw["cross_ctx"] = rng.standard_normal((b, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32)
    return kw


def jax_run(cfg, params, kw):
    """Train, prefill and one greedy decode step of the JAX package."""
    out = {"train": JM.forward(params, cfg, mode="train", **kw)}
    if not cfg.encoder_only:
        caches = JM.init_caches(cfg, B, MAX_LEN)
        lp, caches, _ = JM.forward(params, cfg, mode="prefill", caches=caches, **kw)
        nxt = jnp.argmax(lp[:, -1], -1)[:, None].astype(jnp.int32)
        dec = dict(kw, tokens=nxt)
        ld, c2, _ = JM.forward(params, cfg, mode="decode", caches=caches,
                               positions=jnp.full((B, 1), S, jnp.int32), **dec)
        out.update(prefill=(lp, caches), decode=(ld, c2), next=nxt)
    return out


def run_both(cfg, tcfg, seed=0):
    """(JAX outputs as numpy, the port's params, the numpy inputs)."""
    jp = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(seed))
    kw = inputs_np(cfg)
    out = jax.jit(lambda p, k: jax_run(cfg, p, k))(jp, {k: jnp.asarray(v) for k, v in kw.items()})
    out = jax.tree.map(np.asarray, out)
    return out, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), kw


@pytest.fixture(scope="module")
def arch_runs():
    """Each arch's JAX outputs, computed at its first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = run_both(JR.get_smoke_config(arch), TR.get_smoke_config(arch))
        return cache[arch]

    return get


def torch_kw(kw, **over):
    return {k: torch.from_numpy(np.array(v)) for k, v in dict(kw, **over).items()}


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", JR.ARCHS)
def test_configs_equal_jax(arch):
    for getter in ("get_config", "get_smoke_config"):
        mine, theirs = getattr(TR, getter)(arch), getattr(JR, getter)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.n_layers == theirs.n_layers
        assert TM.model_flops_per_token(mine, False) == JM.model_flops_per_token(theirs, False)
    for shape in TB.SHAPES:
        assert TR.cell_skip_reason(arch, shape) == JR.cell_skip_reason(arch, shape)


def test_registry_and_shapes_equal_jax():
    assert TR.ARCHS == JR.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    assert TR.all_cells() == JR.all_cells()
    with pytest.raises(KeyError):
        TR.get_config("no-such-arch")


# -------------------------------------------------------------- params
@pytest.mark.parametrize("arch", JR.ARCHS)
def test_init_params_has_the_jax_layout(arch):
    """The port's own init gives JAX's tree: same keys, shapes and dtypes
    (pattern leaves stacked along ``n_repeats``); so do the caches."""
    cfg = TR.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, JR.get_smoke_config(arch)), jax.random.PRNGKey(0))
    mine = TM.init_params(0, cfg, device="cpu")
    again = TM.init_params(0, cfg, device="cpu")

    def same(m, t, a):
        if isinstance(t, dict):
            assert set(m) == set(t)
            for k in t:
                same(m[k], t[k], a[k])
        else:
            assert tuple(m.shape) == t.shape and str(m.dtype).split(".")[-1] == str(t.dtype)
            assert torch.equal(m, a)  # seeded

    same(mine, shapes, again)
    jc = jax.eval_shape(lambda: JM.init_caches(JR.get_smoke_config(arch), 3, 20))
    tc = TM.init_caches(cfg, 3, 20, device="cpu")
    same(tc, jc, TM.init_caches(cfg, 3, 20, device="cpu"))


def test_params_from_jax_is_a_relabel_bf16_included():
    cfg = JR.get_smoke_config("yi-6b")
    jp = jax.jit(lambda k: JM.init_params(k, dataclasses.replace(cfg, param_dtype="bfloat16")))(
        jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, jp)
    mine = TM.params_from_jax(host, device="cpu")
    leaf = mine["pattern"]["block0"]["attn"]["q"]["kernel"]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == (cfg.n_repeats, cfg.d_model, 128)
    want = np.asarray(jp["pattern"]["block0"]["attn"]["q"]["kernel"]).astype(np.float32)
    assert np.array_equal(leaf.to(torch.float32).numpy(), want)


# ------------------------------------------------------- whole models
@pytest.mark.parametrize("arch", JR.ARCHS)
def test_train_forward_matches_jax(arch, arch_runs):
    out, params, kw = arch_runs(arch)
    logits, caches, aux = TM.forward(params, TR.get_smoke_config(arch), mode="train", **torch_kw(kw))
    assert caches is None
    assert_tree_close(logits, out["train"][0])
    assert_tree_close(aux, out["train"][2])


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_matches_jax(arch, arch_runs):
    """Prefill logits and every cache leaf."""
    out, params, kw = arch_runs(arch)
    cfg = TR.get_smoke_config(arch)
    caches = TM.init_caches(cfg, B, MAX_LEN, device="cpu")
    logits, new, _ = TM.forward(params, cfg, mode="prefill", caches=caches, **torch_kw(kw))
    assert_tree_close(logits, out["prefill"][0])
    assert_tree_close(new, out["prefill"][1])
    # the caller's caches are left as they were (JAX's functional update)
    assert_tree_close(caches, jax.tree.map(np.asarray, JM.init_caches(JR.get_smoke_config(arch), B, MAX_LEN)),
                      rtol=0, atol=0)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_jax(arch, arch_runs):
    """One decode step from JAX's prefill caches, carried over."""
    out, params, kw = arch_runs(arch)
    cfg = TR.get_smoke_config(arch)
    caches = TM.caches_from_jax(out["prefill"][1], device="cpu")
    logits, new, _ = TM.forward(params, cfg, mode="decode", caches=caches,
                                positions=torch.full((B, 1), S, dtype=torch.int32),
                                **torch_kw(kw, tokens=out["next"]))
    assert_tree_close(logits, out["decode"][0])
    assert_tree_close(new, out["decode"][1])


def _dropless(cfg):
    """Einsum MoE dispatch drops tokens past capacity; raise it so prefill +
    decode can equal the train forward (the JAX test's ``_dropless``)."""
    pattern = tuple(dataclasses.replace(b, moe=dataclasses.replace(b.moe, capacity_factor=8.0))
                    if b.moe is not None else b for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_equals_train_forward(arch):
    """Within the port: prefill(S) + decode(1) equals the train forward at
    the last position (the JAX package's own check, 5e-2)."""
    cfg = _dropless(TR.get_smoke_config(arch))
    params = TM.init_params(0, cfg, device="cpu")
    kw = torch_kw(inputs_np(cfg))
    lp, caches, _ = TM.forward(params, cfg, mode="prefill", caches=TM.init_caches(cfg, B, MAX_LEN, device="cpu"),
                               **kw)
    nxt = torch.argmax(lp[:, -1], -1)[:, None]
    ld, _, _ = TM.forward(params, cfg, mode="decode", caches=caches,
                          positions=torch.full((B, 1), S, dtype=torch.int32), **dict(kw, tokens=nxt))
    lf, _, _ = TM.forward(params, cfg, mode="train", **dict(kw, tokens=torch.cat([kw["tokens"], nxt], 1)))
    assert float((lf[:, -1] - ld[:, 0]).abs().max()) < 5e-2


def test_int8_kv_cache_matches_jax():
    """KIVI-style int8 caches (qwen1.5-110b's full config sets them): the
    int8 values equal JAX's but where a value sits on a rounding boundary
    (counted: at most one in a thousand, one step apart), the scales and
    logits within the fp32 tolerance."""
    cfg = dataclasses.replace(JR.get_smoke_config("qwen1.5-110b"), kv_cache_dtype="int8")
    tcfg = dataclasses.replace(TR.get_smoke_config("qwen1.5-110b"), kv_cache_dtype="int8")
    out, params, kw = run_both(cfg, tcfg)
    caches = TM.init_caches(tcfg, B, MAX_LEN, device="cpu")
    logits, new, _ = TM.forward(params, tcfg, mode="prefill", caches=caches, **torch_kw(kw))
    assert_tree_close(logits, out["prefill"][0])
    jc = out["prefill"][1]["pattern"]["block0"]["attn"]
    mc = new["pattern"]["block0"]["attn"]
    differ = 0
    for name in ("k", "v"):
        assert mc[name].dtype == torch.int8
        d = np.abs(mc[name].numpy().astype(np.int32) - jc[name].astype(np.int32))
        assert d.max() <= 1
        differ += int((d != 0).sum())
        assert_tree_close(mc[f"{name}_scale"], jc[f"{name}_scale"])
    assert differ <= mc["k"].numel() * 2 // 1000, differ
    dec, new2, _ = TM.forward(params, tcfg, mode="decode", caches=TM.caches_from_jax(out["prefill"][1], device="cpu"),
                              positions=torch.full((B, 1), S, dtype=torch.int32),
                              **torch_kw(kw, tokens=out["next"]))
    assert_tree_close(dec, out["decode"][0])


def test_bf16_logits_within_jax_bf16_error():
    """yi-6b smoke with bf16 activations: the port's bf16 logits are no
    farther from JAX's bf16 logits than JAX's bf16 logits are from JAX's
    fp32 logits."""
    base = JR.get_smoke_config("yi-6b")
    jp = jax.jit(lambda k: JM.init_params(k, base))(jax.random.PRNGKey(0))
    kw = inputs_np(base)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def logits(cfg):
        return np.asarray(jax.jit(lambda p, k: JM.forward(p, cfg, mode="train", **k)[0])(jp, jkw), np.float32)

    j32, j16 = logits(base), logits(dataclasses.replace(base, act_dtype="bfloat16"))
    params = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = dataclasses.replace(TR.get_smoke_config("yi-6b"), act_dtype="bfloat16")
    t16 = TM.forward(params, tcfg, mode="train", **torch_kw(kw))[0]
    assert t16.dtype == torch.bfloat16
    gap = np.abs(t16.float().numpy() - j16).max()
    assert gap <= np.abs(j16 - j32).max(), (gap, np.abs(j16 - j32).max())
