"""The port's LM sharding on several ranks: CPU ``gloo`` process groups
spawned by ``tests/torch_lm_ranks.py`` (each through a ``file://`` store in
the test's directory, one thread per rank), held to the JAX package's
single-device output on the same numpy inputs.

JAX's own sharded train step and GPipe are red on jax 0.9.0 (ROADMAP,
"Failures in the reference itself"), so the port's sharded paths are held
to single-device output, at the JAX package's tolerances:

* every arch's smoke train step on a (2, 2) mesh, and yi-6b on (2, 4):
  loss within 1e-3 and parameters within 5e-3 (``tests/test_distributed.py:67-70``)
  of JAX's jitted single-device step (parameters carried across by
  ``params_from_jax``) and of the port's own single-device step, and the
  grad norm and first moments within ``GNORM_RTOL`` and ``MOMENT_RTOL``
  (relative), which see the backward pass and the clipping scale;
* ring attention on an 8-rank ``data`` axis, JAX's four (spec, softcap)
  cases, within atol 3e-5 of JAX's ``_sdpa_plain``;
* GPipe with 4 stages, 8 microbatches of 2, D 16, within atol 1e-5 of the
  sequential form;
* ``elastic_restore`` of a JAX checkpoint onto (4, 2), and of a port
  checkpoint written under (2, 2) onto (4, 1): leaves equal, placements as
  ``train_state_shardings`` says;
* ``global_norm`` of a ``Partial`` leaf, and ``device_put``'s local cut of
  uneven shards against DTensor's own;
* ``compressed_mean_grads`` over a ``DeviceMesh``: relative error under
  0.02 (JAX's bound) and equal bit for bit to its ``BatchMesh`` form;
* the launcher with ``--smoke --mesh 2x2`` on 4 ranks: losses within 1e-3
  of the single-device launcher's at the same seed.

Two spawns carry every case: one of 4 ranks and one of 8; the JAX
references run while the ranks do.
"""
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as JR
import repro.models as JM
import repro.train as JT
import repro_torch.configs.registry as TR
import repro_torch.models as TM
import repro_torch.train as TT
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.base import AttnSpec as JaxAttnSpec
from repro.models.attention import _sdpa_plain as jax_sdpa_plain
from repro.train.optimizer import adamw_init as jax_adamw_init

HERE = os.path.dirname(os.path.abspath(__file__))
LOSS_TOL, PARAM_TOL = 1e-3, 5e-3  # tests/test_distributed.py:67-70
# One AdamW step at warm-up 1 moves each parameter by about lr whatever the
# gradient, so PARAM_TOL cannot see the backward pass: the grad norm and the
# first moments (the clipped gradient) are held at these relative limits,
# set from the readings of sound runs (PERF.md, PR 25)
GNORM_RTOL, MOMENT_RTOL = 1e-5, 1e-4
B, S = 4, 8
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
RING_CASES = [(dict(kind="global"), 0.0), (dict(kind="global", causal=False), 0.0),
              (dict(kind="local", window=24), 0.0), (dict(kind="global"), 30.0)]
ELASTIC_ARCH = "stablelm-1.6b"


def _batch(cfg, rng):
    b = {}
    if cfg.frontend == "audio":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        b["cross_ctx"] = rng.standard_normal((B, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def _reference_inputs(archs):
    """Per arch: the JAX package's parameters (as the port's tensors, by
    ``params_from_jax``) and a batch."""
    ref = {}
    for i, arch in enumerate(archs):
        cfg = JR.get_smoke_config(arch)
        params = JM.init_params(jax.random.PRNGKey(i), cfg)
        ref[arch] = {"jax": params, "params": TM.params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
                     "batch": _batch(cfg, np.random.default_rng(i))}
    return ref


def _reference_steps(ref):
    """JAX's jitted step and the port's single-device step on each arch's
    inputs."""
    for arch, r in ref.items():
        cfg = JR.get_smoke_config(arch)
        jp, jo, jm = jax.jit(JT.make_train_step(cfg, JT.OptConfig(**OPT)))(
            r["jax"], JT.init_train_state(r["jax"]), {k: jnp.asarray(v) for k, v in r["batch"].items()})
        pp, po, pm = TT.make_train_step(TR.get_smoke_config(arch), TT.OptConfig(**OPT))(
            r["params"], TT.init_train_state(r["params"]), r["batch"])
        r["ref"] = {
            "jax": {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
                    "params": [np.asarray(a) for a in jax.tree.leaves(jp)],
                    "m": [np.asarray(a) for a in jax.tree.leaves(jo["m"])]},
            "port": {"loss": float(pm["loss"]), "grad_norm": float(pm["grad_norm"]),
                     "params": [t.numpy() for t in TM.tree_leaves(pp)], "m": [t.numpy() for t in TM.tree_leaves(po["m"])]},
        }


def _spawn(case, world, work, inputs, ref, timeout=600):
    """Start the case's ranks, compute the single-device references
    meanwhile, then wait for the ranks and read rank 0's results."""
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_lm_ranks.py"), case, str(world), str(work)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _reference_steps(ref)
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return torch.load(os.path.join(work, "results.pt"), weights_only=False)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh22")
    ref = _reference_inputs(TR.ARCHS)
    g = np.random.default_rng(7).standard_normal((4, 64, 32)).astype(np.float32)
    inputs = {"archs": list(TR.ARCHS), "params": {a: r["params"] for a, r in ref.items()}, "batch": {a: r["batch"] for a, r in ref.items()},
              "grads": torch.from_numpy(g)}
    return ref, _spawn("mesh22", 4, work, inputs, ref), g, work


@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh8")
    ref = _reference_inputs(["yi-6b"])
    rng = np.random.default_rng(3)
    Bq, Sq, H, KV, D = 2, 64, 4, 2, 16
    ring = {"q": rng.standard_normal((Bq, Sq, H, D)).astype(np.float32),
            "k": rng.standard_normal((Bq, Sq, KV, D)).astype(np.float32),
            "v": rng.standard_normal((Bq, Sq, KV, D)).astype(np.float32),
            "pos": np.broadcast_to(np.arange(Sq, dtype=np.int32)[None], (Bq, Sq)).copy()}
    P_STAGES, N_MICRO, MB, DG = 4, 8, 2, 16
    gp = {"ws": (rng.standard_normal((P_STAGES, DG, DG)) / np.sqrt(DG)).astype(np.float32),
          "xs": rng.standard_normal((N_MICRO, MB, DG)).astype(np.float32)}
    # a JAX checkpoint written on one device
    cfg = JR.get_smoke_config(ELASTIC_ARCH)
    jparams = JM.init_params(jax.random.PRNGKey(0), cfg)
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    ckpt = str(work / "jax_ckpt")
    JaxCheckpointManager(ckpt, async_save=False).save(3, jstate, {"step": 3})
    inputs = {"archs": ["yi-6b"], "params": {a: r["params"] for a, r in ref.items()},
              "batch": {a: r["batch"] for a, r in ref.items()},
              "ring": {k: torch.from_numpy(v) for k, v in ring.items()},
              "gpipe": {k: torch.from_numpy(v) for k, v in gp.items()},
              "elastic_arch": ELASTIC_ARCH, "jax_ckpt": ckpt}
    out = _spawn("mesh8", 8, work, inputs, ref)
    return ref, out, ring, gp, [np.asarray(a) for a in jax.tree.leaves(jstate)]


def _worst_rel(mine, want):
    """The largest difference over the leaves, each relative to its
    reference leaf's largest magnitude."""
    return max(float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30)) for a, b in zip(mine, want))


def _held(ref, got, arch):
    """The sharded step against JAX's single-device step and the port's:
    the loss (the forward pass), the grad norm (the whole gradient and the
    clipping scale), the first moments (the clipped gradient leaf by leaf:
    after one step ``m = (1 - b1) * g * scale``) and the parameters."""
    mine = {"params": [t.detach().numpy() for t in TM.tree_leaves(got["params"])],
            "m": [t.detach().numpy() for t in TM.tree_leaves(got["m"])]}
    for side, want in ref[arch]["ref"].items():
        assert len(mine["m"]) == len(want["m"]) == len(mine["params"]) == len(want["params"])
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (arch, side, got["loss"], want["loss"])
        gnorm_rel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        assert gnorm_rel < GNORM_RTOL, (arch, side, got["grad_norm"], want["grad_norm"])
        m_rel = _worst_rel(mine["m"], want["m"])
        assert m_rel < MOMENT_RTOL, (arch, side, m_rel)
        d_param = max(float(np.max(np.abs(a - b))) for a, b in zip(mine["params"], want["params"]))
        assert d_param < PARAM_TOL, (arch, side, d_param)


@pytest.mark.parametrize("arch", TR.ARCHS)
def test_sharded_train_step_2x2_matches_single_device(arch, mesh22):
    ref, out, _, _ = mesh22
    _held(ref, out["steps"][arch], arch)


def test_sharded_train_step_yi_2x4_matches_single_device(mesh8):
    ref, out, *_ = mesh8
    _held(ref, out["steps"]["yi-6b"], "yi-6b")


@pytest.mark.parametrize("i", range(len(RING_CASES)), ids=["causal", "bidirectional", "window24", "softcap30"])
def test_ring_attention_matches_jax_sdpa_plain(i, mesh8):
    _, out, ring, _, _ = mesh8
    spec, cap = RING_CASES[i]
    q, k, v, pos = (jnp.asarray(ring[n]) for n in ("q", "k", "v", "pos"))
    ref = np.asarray(jax_sdpa_plain(q, k, v, pos, pos, JaxAttnSpec(**spec), cap))
    np.testing.assert_allclose(out["ring"][i].numpy(), ref, atol=3e-5)


def test_gpipe_matches_sequential(mesh8):
    _, out, _, gp, _ = mesh8
    ref = gp["xs"]
    for w in gp["ws"]:
        ref = np.tanh(ref @ w)
    np.testing.assert_allclose(out["gpipe"].numpy(), ref, atol=1e-5)


def test_global_norm_reduces_a_partial_leaf(mesh22):
    got = mesh22[1]["norm_of_partial"]
    assert abs(got["norm"] - got["whole"]) <= 1e-6 * got["whole"], got


def test_device_put_cuts_uneven_shards_as_dtensor_does(mesh22):
    got = mesh22[1]["uneven_put"]
    assert len(got) == 3 and all(g["local_equal"] and g["full_equal"] for g in got), got


def test_elastic_restore_of_a_jax_checkpoint_onto_4x2(mesh8):
    _, out, _, _, jax_leaves = mesh8
    got = out["elastic_jax_to_42"]
    assert got["meta_step"] == 3 and got["placements_as_train_state_shardings"]
    mine = TM.tree_leaves(got["restored"])
    assert len(mine) == len(jax_leaves)
    for a, b in zip(mine, jax_leaves):
        assert np.array_equal(a.numpy(), b)


def test_elastic_restore_of_a_port_checkpoint_from_2x2_onto_4x1(mesh22):
    got = mesh22[1]["elastic_22_to_41"]
    assert got["meta_step"] == 1 and got["placements_as_train_state_shardings"] and got["equal_to_saved"]


def test_compressed_mean_grads_over_a_device_mesh(mesh22):
    _, out, g, _ = mesh22
    red, batch = out["compress"]["mesh"], out["compress"]["batch_mesh"]
    exact = np.broadcast_to(g.mean(axis=0, keepdims=True), g.shape)
    rel = float(np.max(np.abs(red.numpy() - exact)) / np.max(np.abs(exact)))
    assert rel < 0.02, rel
    assert torch.equal(red, batch)


def test_train_launcher_mesh_2x2_on_four_ranks(mesh22, tmp_path):
    from repro_torch.launch.train import main

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        st = main(["--arch", "stablelm-1.6b", "--smoke", "--steps", "3", "--batch", "4", "--seq", "8",
                   "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)
    got = mesh22[1]["launcher"]
    assert got["mesh"] == [2, 2] and got["world_size"] == 4 and got["on_mesh"]
    np.testing.assert_allclose(got["loss"], st["loss"], atol=LOSS_TOL)
    assert os.path.isdir(os.path.join(mesh22[3], "launch22", "step_00000003"))
