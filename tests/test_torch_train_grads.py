"""The port's training loss and its gradients (``repro_torch.train.loss_fn``
under autograd) against the JAX package's ``jax.value_and_grad(loss_fn)``,
for every arch at its smoke config, on the CPU.

The JAX parameters come across with ``params_from_jax`` and both packages
get the same numpy batch. Tolerance: rtol/atol 1e-4 on the loss and its
parts, the forward's tolerance of ``tests/test_torch_models.py``; on each
gradient leaf rtol 1e-4 and atol 1e-4 times the leaf's largest magnitude
where that exceeds 1 (recurrentgemma's embedding table reaches 2.8 through
the tied head and the sqrt(d_model) embedding scale: its float32 summation
noise is about 5e-5 of that, as every other leaf's is of its own). In its
own file so that the test runner's ``--dist loadfile`` puts it on a worker
of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as JR
import repro.train.train_step as JT
import repro.models as JM
import repro_torch.configs.registry as TR
import repro_torch.models as TM
import repro_torch.train as TT

RTOL = ATOL = 1e-4
B, S = 2, 16


def batch_np(cfg, seed=1):
    """tokens (or the audio frontend's embeds), the vision context where the
    arch reads one, and labels."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "audio":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        b["cross_ctx"] = rng.standard_normal((B, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def jax_value_and_grad(cfg, params, batch):
    fn = jax.jit(lambda p, b: jax.value_and_grad(lambda q: JT.loss_fn(q, cfg, b), has_aux=True)(p))
    (loss, parts), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, parts), jax.tree.map(np.asarray, grads)


def torch_value_and_grad(cfg, params, batch):
    live = TM.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = TT.loss_fn(live, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), parts, TM.tree_map(lambda p: p.grad, live)


@pytest.mark.parametrize("arch", JR.ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jp = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.PRNGKey(0))
    batch = batch_np(jcfg)
    jl, jparts, jg = jax_value_and_grad(jcfg, jp, batch)
    tl, tparts, tg = torch_value_and_grad(tcfg, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                                          batch)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[k].detach()), float(jparts[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    jpaths = {"/".join(str(p.key) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    from repro_torch.checkpoint.checkpointer import tree_paths

    tpaths = tree_paths(tg)
    assert set(tpaths) == {k.replace("/", "|") for k in jpaths}
    for key, leaf in jpaths.items():
        mine = tpaths[key.replace("/", "|")]
        assert mine is not None and mine.dtype == torch.float32, key
        atol = ATOL * max(1.0, float(np.abs(leaf).max()))
        np.testing.assert_allclose(mine.numpy(), leaf, rtol=RTOL, atol=atol, err_msg=key)
