"""The port's training substrate (``repro_torch.train``) against the JAX
package's (``repro.train``), on the CPU at smoke size.

Both packages get the same numpy inputs; the JAX parameters come across
with ``params_from_jax``. Tolerances: AdamW over three steps rtol 1e-6; the
learning rate equal to JAX's float32 value at the steps of
``tests/test_train_substrate.py:42`` and over the default schedule, within
two ulps of JAX's eager values elsewhere, equal at over 98 % of steps (the
port's cosine is correctly rounded, XLA's not always; JAX's compiled schedule lies up to 7
ulps from its eager one, so the cross-package Trainer's lr is held at rel
1e-6); a train step's loss rel 1e-4 and
parameters max abs 1e-3 (``tests/test_train_substrate.py:83``, scaled by lr:
Adam's first step amplifies summation noise); int8 compression bit for bit.
The ten archs' loss gradients are in ``test_torch_train_grads.py``.
"""
import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as JR
import repro.models as JM
import repro.train as JT
import repro.train.grad_compress as JG
import repro.train.optimizer as JO
import repro_torch.configs.registry as TR
import repro_torch.models as TM
import repro_torch.train as TT
from repro.data import lm_batches as jax_lm_batches
from repro_torch.data import lm_batches
from repro_torch.sharding import BatchMesh


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    """Both Trainers install SIGTERM/SIGINT handlers; put the runner's back."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    yield
    for sig, h in saved.items():
        signal.signal(sig, h)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_np(tree):
    return [t.detach().numpy() for t in TM.tree_leaves(tree)]


def max_param_diff(jax_params, port_params):
    return max(float(np.max(np.abs(np.asarray(a) - b)))
               for a, b in zip(jax.tree.leaves(jax_params), leaves_np(port_params)))


# ------------------------------------------------------------- optimizer
def test_adamw_update_matches_jax_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "blk": {"u": (2, 5), "s": (5,)}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=2.0)
    jp, js = jax.tree.map(jnp.asarray, p0), JO.adamw_init(jax.tree.map(jnp.asarray, p0))
    tp = TM.tree_map(torch.from_numpy, p0)
    ts = TT.adamw_init(tp)
    for g in grads:
        jp, js, jm = JO.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, JO.OptConfig(**cfg))
        tp, ts, tm = TT.adamw_update(TM.tree_map(torch.from_numpy, g), ts, tp, TT.OptConfig(**cfg))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    for mine, theirs in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(leaves_np(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3


def test_adamw_in_place_equals_functional_bit_for_bit():
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}
    g = TM.tree_map(lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)), p)
    cfg = TT.OptConfig(lr=1e-2, warmup_steps=1, decay_steps=5)
    st = TT.adamw_init(p)
    fp, fs, fm = TT.adamw_update(g, st, p, cfg)
    assert int(st["step"]) == 0 and not torch.equal(fp["w"], p["w"])  # inputs as they were
    ip, is_, im = TT.adamw_update(g, st, p, cfg, in_place=True)
    assert ip is p and is_ is st and int(st["step"]) == 1
    for a, b in zip(TM.tree_leaves([fp, fs["m"], fs["v"]][0]) + TM.tree_leaves(fs["m"]) + TM.tree_leaves(fs["v"]),
                    TM.tree_leaves(ip) + TM.tree_leaves(is_["m"]) + TM.tree_leaves(is_["v"])):
        assert torch.equal(a, b)
    assert float(fm["grad_norm"]) == float(im["grad_norm"])


def test_lr_at_step_equals_jax_float32():
    cfg = dict(lr=1.0, warmup_steps=10, decay_steps=110, min_lr_ratio=0.1)
    steps = (0, 5, 10, 60, 110, 500)
    mine = [np.float32(TT.lr_at_step(TT.OptConfig(**cfg), torch.tensor(s))) for s in steps]
    theirs = [np.float32(JO.lr_at_step(JO.OptConfig(**cfg), jnp.asarray(s))) for s in steps]
    assert mine == theirs
    # three schedules (the default one past its end, the example's) against
    # JAX's eager values: within two ulps (the cosine); JAX compiled is no
    # oracle here, its own values lie up to 7 ulps from its eager ones
    for c, stop, stride in ((cfg, 600, 1), ({}, 12_000, 13), (dict(lr=6e-4, warmup_steps=30, decay_steps=300), 400, 1)):
        s = range(0, stop, stride)
        mine = np.asarray([np.float32(TT.lr_at_step(TT.OptConfig(**c), torch.tensor(i))) for i in s])
        theirs = np.asarray([np.float32(JO.lr_at_step(JO.OptConfig(**c), jnp.asarray(i))) for i in s])
        np.testing.assert_array_max_ulp(mine, theirs, maxulp=2)
        assert (mine == theirs).mean() > 0.98
    assert TT.lr_at_step(TT.OptConfig(**cfg), torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def test_grad_clip_applied():
    cfg = TT.OptConfig(lr=1.0, grad_clip=0.1, warmup_steps=1, decay_steps=2, weight_decay=0.0, min_lr_ratio=1.0)
    p = {"w": torch.zeros(4)}
    _, _, metrics = TT.adamw_update({"w": torch.full((4,), 100.0)}, TT.adamw_init(p), p, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_global_norm_sums_in_jax_leaf_order():
    tree = {"b": torch.tensor([3.0]), "a": {"y": torch.tensor([4.0]), "x": torch.tensor([12.0])}}
    assert [float(t) for t in TM.tree_leaves(tree)] == [12.0, 4.0, 3.0]
    assert float(TT.global_norm(tree)) == 13.0


# ------------------------------------------------------------ train step
def _yi(accum):
    return (dataclasses.replace(JR.get_smoke_config("yi-6b"), grad_accum=accum),
            dataclasses.replace(TR.get_smoke_config("yi-6b"), grad_accum=accum))


@pytest.fixture(scope="module")
def yi_step_inputs():
    jcfg, _ = _yi(1)
    jp = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.PRNGKey(0))
    batch = next(lm_batches(jcfg.vocab_size, 8, 16, 1, seed=0))
    return jp, batch


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, yi_step_inputs):
    jp, batch = yi_step_inputs
    jcfg, tcfg = _yi(accum)
    opt = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    p1, _, m1 = jax.jit(JT.make_train_step(jcfg, JO.OptConfig(**opt)))(
        jp, JT.init_train_state(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = TM.params_from_jax(np_tree(jp), device="cpu")
    before = [t.clone() for t in TM.tree_leaves(tp)]
    st = TT.init_train_state(tp)
    p2, s2, m2 = TT.make_train_step(tcfg, TT.OptConfig(**opt))(tp, st, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-4)
    assert float(m2["lr"]) == float(m1["lr"])
    assert max_param_diff(p1, p2) < 1e-3
    # the step leaves its inputs as they were (JAX's is functional)
    assert all(torch.equal(a, b) for a, b in zip(before, TM.tree_leaves(tp)))
    assert int(st["step"]) == 0 and int(s2["step"]) == 1


def test_grad_accum_equivalence_in_the_port(yi_step_inputs):
    jp, batch = yi_step_inputs
    opt = TT.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    tp = TM.params_from_jax(np_tree(jp), device="cpu")
    out = {}
    for accum in (1, 2):
        cfg = _yi(accum)[1]
        out[accum] = TT.make_train_step(cfg, opt)(tp, TT.init_train_state(tp), batch)
    d = max(float((a - b).abs().max()) for a, b in zip(TM.tree_leaves(out[1][0]), TM.tree_leaves(out[2][0])))
    assert d < 1e-3, d
    assert float(out[1][2]["loss"]) == pytest.approx(float(out[2][2]["loss"]), rel=1e-4)


def test_donated_step_updates_in_place(yi_step_inputs):
    jp, batch = yi_step_inputs
    cfg = _yi(2)[1]
    opt = TT.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    fresh = lambda: TM.params_from_jax(np_tree(jp), device="cpu")
    fp, fs, fm = TT.make_train_step(cfg, opt)(fresh(), TT.init_train_state(fresh()), batch)
    tp = fresh()
    st = TT.init_train_state(tp)
    dp, ds, dm = TT.make_train_step(cfg, opt, donate=True)(tp, st, batch)
    assert dp is tp and ds is st and int(st["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(TM.tree_leaves(fp), TM.tree_leaves(tp)))
    assert all(torch.equal(a, b) for a, b in zip(TM.tree_leaves(fs["v"]), TM.tree_leaves(st["v"])))
    assert float(fm["loss"]) == float(dm["loss"])


# ------------------------------------------------------------------ remat
def test_remat_policies_give_equal_loss_and_grads(monkeypatch):
    """"full", "dots" and "none" on stablelm smoke: the same loss and
    gradients; "full" and "dots" run each repeat's blocks again in the
    backward pass, "none" does not."""
    import repro_torch.models.model as model_mod

    base = TR.get_smoke_config("stablelm-1.6b")
    params = TM.init_params(0, base, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(lm_batches(base.vocab_size, 2, 16, 1, seed=3)).items()}
    calls = []
    real = model_mod.block_apply
    monkeypatch.setattr(model_mod, "block_apply", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in ("full", "dots", "none"):
        calls.clear()
        live = TM.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = TT.loss_fn(live, dataclasses.replace(base, remat=remat), batch)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in TM.tree_leaves(live)], len(calls))
    n = base.n_repeats * len(base.pattern)
    assert (out["full"][2], out["dots"][2], out["none"][2]) == (2 * n, 2 * n, n)
    for remat in ("dots", "none"):
        assert torch.equal(out[remat][0], out["full"][0])
        for a, b in zip(out[remat][1], out["full"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():  # no autograd: no remat, the serving path
        calls.clear()
        TM.forward(params, base, tokens=batch["tokens"], mode="train")
        assert len(calls) == n


def test_dots_policy_keeps_the_matrix_products():
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models.model import _save_dots

    for op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default):
        assert _save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    assert _save_dots(None, torch.ops.aten.mul.Tensor) == CheckpointPolicy.PREFER_RECOMPUTE


def test_bf16_activation_grads_within_jax_bf16_error():
    """stablelm smoke with bf16 activations (the weights cast inside the
    graph, their gradients back in fp32): the port's bf16 gradients are no
    farther from JAX's bf16 gradients than JAX's bf16 gradients are from
    JAX's fp32 ones."""
    base = JR.get_smoke_config("stablelm-1.6b")
    jp = jax.jit(lambda k: JM.init_params(k, base))(jax.random.PRNGKey(0))
    batch = next(lm_batches(base.vocab_size, 2, 16, 1, seed=5))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_grads(cfg):
        return jax.tree.leaves(np_tree(jax.jit(jax.grad(lambda p: JT.loss_fn(p, cfg, jb)[0]))(jp)))

    j32, j16 = jax_grads(base), jax_grads(dataclasses.replace(base, act_dtype="bfloat16"))
    tcfg = dataclasses.replace(TR.get_smoke_config("stablelm-1.6b"), act_dtype="bfloat16")
    live = TM.tree_map(lambda p: p.detach().requires_grad_(True), TM.params_from_jax(np_tree(jp), device="cpu"))
    loss, _ = TT.loss_fn(live, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    t16 = [p.grad for p in TM.tree_leaves(live)]
    assert all(g.dtype == torch.float32 for g in t16)
    gap = max(float(np.abs(a.numpy() - b).max()) for a, b in zip(t16, j16))
    ref = max(float(np.abs(a - b).max()) for a, b in zip(j16, j32))
    assert 0 < gap <= ref, (gap, ref)


# ---------------------------------------------------------------- trainer
def test_trainer_resume_continues_step_count(tmp_path):
    cfg = TR.get_smoke_config("stablelm-1.6b")
    opt = TT.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    t1 = TT.Trainer(cfg, opt, str(tmp_path), ckpt_every=3, device="cpu")
    assert t1.init_or_resume() == "initialized"
    t1.run(lm_batches(cfg.vocab_size, 4, 16, 5, seed=1), max_steps=5)
    assert t1.ckpt.steps() == [3, 5]
    t2 = TT.Trainer(cfg, opt, str(tmp_path), ckpt_every=3, device="cpu")
    assert t2.init_or_resume() == "resumed"
    assert t2.step == 5 and int(t2.opt_state["step"]) == 5
    for a, b in zip(TM.tree_leaves(t1.params), TM.tree_leaves(t2.params)):
        assert torch.equal(a, b)
    hb = json.load(open(os.path.join(tmp_path, "heartbeat.json")))
    assert hb["step"] == 5 and hb["step_time"] > 0


def test_cross_package_resume(tmp_path):
    """JAX's Trainer trains 3 steps; both packages resume from a copy of its
    checkpoint and train to step 6 on the same batches."""
    jcfg, tcfg = JR.get_smoke_config("stablelm-1.6b"), TR.get_smoke_config("stablelm-1.6b")
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=20)
    jt = JT.Trainer(jcfg, JO.OptConfig(**opt), str(tmp_path / "jax"), ckpt_every=3)
    jt.init_or_resume()
    jt.run(jax_lm_batches(jcfg.vocab_size, 4, 16, 3, seed=1), max_steps=3)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jlog, tlog = [], []
    jt2 = JT.Trainer(jcfg, JO.OptConfig(**opt), str(tmp_path / "jax"), ckpt_every=100)
    assert jt2.init_or_resume() == "resumed" and jt2.step == 3
    jt2.run(jax_lm_batches(jcfg.vocab_size, 4, 16, 3, seed=7), max_steps=6, log_fn=lambda s, m: jlog.append(m))
    tt = TT.Trainer(tcfg, TT.OptConfig(**opt), str(tmp_path / "port"), ckpt_every=100, device="cpu")
    assert tt.init_or_resume() == "resumed" and tt.step == 3
    tt.run(lm_batches(tcfg.vocab_size, 4, 16, 3, seed=7), max_steps=6, log_fn=lambda s, m: tlog.append(m))
    assert tt.step == jt2.step == 6
    for a, b in zip(tlog, jlog):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert max_param_diff(jt2.params, tt.params) < 1e-3


def test_preemption_saves_synchronously_and_stops(tmp_path):
    """A SIGTERM mid-run: the Trainer's handler sets ``_preempted``, the
    loop stops before the next step and saves that step synchronously."""
    cfg = TR.get_smoke_config("stablelm-1.6b")
    tr = TT.Trainer(cfg, TT.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10), str(tmp_path),
                    ckpt_every=100, device="cpu")
    tr.init_or_resume()

    def log(step, m):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    tr.run(lm_batches(cfg.vocab_size, 2, 8, 6, seed=0), max_steps=6, log_fn=log)
    assert tr._preempted and tr.step == 2
    assert tr.ckpt.steps() == [2] and tr.save_seconds[-1]["sync"]
    assert json.load(open(os.path.join(tmp_path, "step_00000002", "meta.json")))["step"] == 2


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is it")
    cfg = TR.get_smoke_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Trainer(cfg, TT.OptConfig(), str(tmp_path))
    from repro_torch.launch.train import train_lm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm("stablelm-1.6b", smoke=True, steps=1, ckpt_dir=str(tmp_path))


# -------------------------------------------------------- grad compression
@pytest.mark.parametrize("shape", [(1000,), (64, 32)])
def test_quantize_roundtrip_is_jax_bit_for_bit(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    mine = TT.quantize_dequantize_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(JG.quantize_dequantize_roundtrip(jnp.asarray(x))))
    assert np.abs(mine - x).max() / np.abs(x).max() < 1.0 / 127.0 + 1e-6


def _psum_int8_numpy(g, n):
    """``_psum_int8`` transcribed to numpy: the blocks of ``g``'s leading
    axis are the devices' shards."""
    shards = np.split(g, n, axis=0)
    scale = np.float32(max(np.abs(s).max() for s in shards)) / np.float32(127.0)
    scale = np.maximum(scale, np.float32(1e-20))
    total = sum(np.clip(np.round(s / scale), -127, 127).astype(np.int32) for s in shards)
    mean = (total.astype(np.float32) * scale) / np.float32(n)
    return np.concatenate([mean] * n, axis=0)


def test_compressed_mean_grads_on_a_batch_mesh():
    """tests/test_distributed.py:108's case on the port's mesh: 8 devices
    (the CPU named 8 times), an (8, 64, 32) gradient."""
    g = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 64, 32)))
    mesh = BatchMesh(("cpu",) * 8)
    out = TT.compressed_mean_grads({"w": torch.from_numpy(g)}, mesh, dp_axes=("batch",))["w"].numpy()
    exact = np.broadcast_to(g.mean(axis=0, keepdims=True), g.shape)
    assert np.abs(out - exact).max() / np.abs(exact).max() < 0.02
    np.testing.assert_allclose(out, _psum_int8_numpy(g, 8), rtol=0, atol=1e-6)
    grads = {"w": torch.from_numpy(g)}
    assert TT.compressed_mean_grads(grads, mesh) is grads  # no ("pod", "data") axis: as they are


# ------------------------------------------------ train -> checkpoint -> serve
def test_train_checkpoint_serve_roundtrip(tmp_path):
    """tests/test_system.py:23's lifecycle in the port: train, checkpoint,
    resume into a serving engine, generate deterministically."""
    from repro_torch.serving import Request, ServeEngine

    cfg = TR.get_smoke_config("yi-6b")
    opt = TT.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=20)
    tr = TT.Trainer(cfg, opt, str(tmp_path), ckpt_every=5, device="cpu")
    tr.init_or_resume()
    tr.run(lm_batches(cfg.vocab_size, 4, 16, 10, seed=3), max_steps=10)
    tr2 = TT.Trainer(cfg, opt, str(tmp_path), device="cpu")
    assert tr2.init_or_resume() == "resumed" and tr2.step == 10

    def generate():
        eng = ServeEngine(cfg, tr2.params, max_slots=2, max_len=48, device="cpu")
        reqs = [Request(uid=i, prompt=[1 + i, 2, 3], max_tokens=5) for i in range(2)]
        for r in reqs:
            assert eng.submit(r)
        eng.run_to_completion()
        return [r.generated for r in reqs]

    first = generate()
    assert all(len(g) == 5 for g in first) and generate() == first
