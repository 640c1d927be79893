"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), on the CPU: the same on-disk layout
(``arrays.npz`` keyed by the ``|``-joined tree path, ``meta.json``), atomic
writes, bit-for-bit restores across the packages both ways, the
``CheckpointManager``'s retention, latest step and async errors, and the
serving launcher's ``--ckpt-dir``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as JC
import repro.configs.registry as JR
import repro.models as JM
import repro.train as JT
import repro_torch.checkpoint as TC
import repro_torch.configs.registry as TR
import repro_torch.models as TM
import repro_torch.train as TT
from repro_torch.checkpoint.checkpointer import tree_paths


def small_tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)},
            "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16), "s": torch.zeros((), dtype=torch.int32)}


def meta_like(tree):
    return TM.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def test_checkpoint_roundtrip_bit_for_bit(tmp_path):
    tree = small_tree()
    TC.save_pytree(str(tmp_path / "ck"), tree, {"step": 7})
    out = TC.load_pytree(str(tmp_path / "ck"), meta_like(tree), device="cpu")
    for k, (a, b) in enumerate(zip(TM.tree_leaves(out), TM.tree_leaves(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert json.load(open(tmp_path / "ck" / "meta.json")) == {"step": 7}


def test_a_failed_write_leaves_nothing_visible(tmp_path):
    class Broken:
        shape = (2,)

        def __array__(self, *a, **k):
            raise OSError("disk gone")

    with pytest.raises(OSError):
        TC.save_pytree(str(tmp_path / "ck"), {"a": torch.ones(2), "z": Broken()})
    assert os.listdir(tmp_path) == []
    # over an existing checkpoint: it stays whole
    TC.save_pytree(str(tmp_path / "ck"), {"a": torch.ones(2)}, {"step": 1})
    with pytest.raises(OSError):
        TC.save_pytree(str(tmp_path / "ck"), {"a": torch.zeros(2), "z": Broken()}, {"step": 2})
    assert os.listdir(tmp_path) == ["ck"]
    out = TC.load_pytree(str(tmp_path / "ck"), {"a": torch.empty(2, device="meta")}, device="cpu")
    assert torch.equal(out["a"], torch.ones(2))


def test_mismatched_shape_and_missing_key_raise(tmp_path):
    TC.save_pytree(str(tmp_path / "ck"), {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_pytree(str(tmp_path / "ck"), {"a": torch.empty(4, device="meta")}, device="cpu")
    with pytest.raises(ValueError, match="missing keys"):
        TC.load_pytree(str(tmp_path / "ck"), {"a": torch.empty(3, device="meta"), "b": torch.empty(1)},
                       device="cpu")


@pytest.fixture(scope="module")
def train_state():
    """yi-6b smoke's parameters and AdamW state after one JAX step (every
    leaf non-trivial), in both packages' forms."""
    cfg = JR.get_smoke_config("yi-6b")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    from repro.data import lm_batches

    batch = {k: jnp.asarray(v) for k, v in next(lm_batches(cfg.vocab_size, 4, 16, 1, seed=0)).items()}
    jp, jo, _ = jax.jit(JT.make_train_step(cfg, JT.OptConfig(lr=1e-3, warmup_steps=1)))(
        jp, JT.init_train_state(jp), batch)
    jstate = {"params": jp, "opt": jo}
    tstate = TM.params_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    return jstate, tstate


def port_like():
    like_p = TM.init_params(0, TR.get_smoke_config("yi-6b"), device="meta")
    return {"params": like_p, "opt": TT.init_train_state(like_p)}


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path, train_state):
    jstate, _ = train_state
    JC.save_pytree(str(tmp_path / "ck"), jstate, {"step": 1, "config": "yi-6b-smoke"})
    out = TC.load_pytree(str(tmp_path / "ck"), port_like(), device="cpu")
    jpaths = {k: np.asarray(v) for k, v in JC.checkpointer.tree_paths(jstate).items()}
    tpaths = tree_paths(out)
    assert list(tpaths) == list(jpaths)
    for k, v in jpaths.items():
        mine = tpaths[k].numpy()
        assert mine.dtype == v.dtype and mine.shape == v.shape, k
        assert mine.tobytes() == v.tobytes(), k
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 1


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path, train_state):
    jstate, tstate = train_state
    meta = {"step": 1, "config": "yi-6b-smoke"}
    TC.save_pytree(str(tmp_path / "port"), tstate, meta)
    JC.save_pytree(str(tmp_path / "jax"), jstate, meta)
    out = JC.load_pytree(str(tmp_path / "port"), jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    with np.load(tmp_path / "port" / "arrays.npz") as zp, np.load(tmp_path / "jax" / "arrays.npz") as zj:
        assert zp.files == zj.files  # the same keys, in the same order
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].tobytes() == zj[k].tobytes(), k
    assert open(tmp_path / "port" / "meta.json").read() == open(tmp_path / "jax" / "meta.json").read()


def test_bf16_leaves_are_stored_as_jax_stores_them(tmp_path):
    """JAX writes a bfloat16 leaf as its two raw bytes (numpy ``V2``); the
    port writes the same bytes and reads JAX's."""
    x = np.asarray([1.5, -2.25, 3.0e-3, 65504.0], np.float32)
    JC.save_pytree(str(tmp_path / "jax"), {"h": jnp.asarray(x, jnp.bfloat16)})
    TC.save_pytree(str(tmp_path / "port"), {"h": torch.from_numpy(x).to(torch.bfloat16)})
    with np.load(tmp_path / "port" / "arrays.npz") as zp, np.load(tmp_path / "jax" / "arrays.npz") as zj:
        assert zp["h"].dtype == zj["h"].dtype == np.dtype("V2") and zp["h"].tobytes() == zj["h"].tobytes()
    out = TC.load_pytree(str(tmp_path / "jax"), {"h": torch.empty(4, dtype=torch.bfloat16, device="meta")},
                         device="cpu")
    assert torch.equal(out["h"], torch.from_numpy(x).to(torch.bfloat16))


# -------------------------------------------------------------- manager
def test_manager_retention_and_latest(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), retention=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor([s])})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    out, meta = mgr.restore({"x": torch.empty(1, dtype=torch.int64, device="meta")}, device="cpu")
    assert int(out["x"][0]) == 4 and meta["step"] == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    with pytest.raises(FileNotFoundError):
        TC.CheckpointManager(str(tmp_path / "empty")).restore({"x": torch.empty(1)}, device="cpu")


def test_async_save_snapshots_before_returning(tmp_path):
    """The trainer may change its tensors as soon as ``save()`` returns:
    the checkpoint holds the values of the call."""
    mgr = TC.CheckpointManager(str(tmp_path))
    x = torch.arange(1000.0)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    out, _ = mgr.restore({"x": torch.empty(1000, device="meta")}, device="cpu")
    assert torch.equal(out["x"], torch.arange(1000.0))


def test_async_error_raises_on_wait(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as manager

    def broken(path, tree, meta=None):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "save_pytree", broken)
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.wait()  # raised once
    mgr.save(2, {"x": torch.ones(2)})  # the next save surfaces its own error at save's wait
    with pytest.raises(RuntimeError):
        mgr.save(3, {"x": torch.ones(2)})
    assert mgr.steps() == []


# ---------------------------------------------------------- serve --ckpt-dir
def test_serve_lm_restores_a_jax_checkpoint(tmp_path, train_state):
    """A checkpoint JAX's Trainer writes is what ``serve_lm(ckpt_dir=)``
    serves: its tokens are those of ``ServeEngine`` on JAX's parameters."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.serving import Request, ServeEngine

    cfg = JR.get_smoke_config("yi-6b")
    tr = JT.Trainer(cfg, JT.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10), str(tmp_path), ckpt_every=100)
    tr.init_or_resume()
    from repro.data import lm_batches

    import signal

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        tr.run(lm_batches(cfg.vocab_size, 4, 16, 2, seed=0), max_steps=2)
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)
    st = serve_lm("yi-6b", smoke=True, requests=3, max_tokens=4, device="cpu", ckpt_dir=str(tmp_path))
    assert st["restored_step"] == 2
    tcfg = TR.get_smoke_config("yi-6b")
    eng = ServeEngine(tcfg, TM.params_from_jax(jax.tree.map(np.asarray, tr.params), device="cpu"),
                      max_slots=4, max_len=256, device="cpu")
    reqs = [Request(uid=i, prompt=list(p), max_tokens=4) for i, p in enumerate(st["prompts"])]
    for r in reqs:
        assert eng.submit(r)
    eng.run_to_completion()
    assert [r.generated for r in reqs] == st["generated"]
    seeded = serve_lm("yi-6b", smoke=True, requests=3, max_tokens=4, device="cpu")
    assert seeded["restored_step"] is None and seeded["generated"] != st["generated"]
