"""The port's logical-axis partitioning (``repro_torch.sharding.partitioning``,
``models.param_logical_axes`` / ``cache_logical_axes``) against the JAX
package's, in one process on the CPU.

The logical axes of every arch (full and smoke configs) equal JAX's tuple
for tuple. ``logical_spec`` and ``param_sharding`` resolve every leaf of
every full-width arch to JAX's spec on the (2, 4), (4, 2), (2, 2, 2) with
``pod``, 16x16 and 2x16x16 meshes: the JAX side runs in a subprocess with
512 forced host devices (as ``tests/test_distributed.py`` runs its meshes),
the port's from axis names and sizes alone (``MeshShape``). Without a mesh
every constraint is a no-op and the models' outputs stay bit for bit what
they are without rules. On a world-1 group (made in this process) the
``Trainer`` resumes onto the active mesh. The multi-rank paths are in
``test_torch_lm_sharding.py``.

Marked ``gpu``, at smoke widths on a world-1 ``nccl`` group: a train step
on a (1, 1) mesh equals the step without a mesh bit for bit, ring
attention on the card's ring of one equals ``_sdpa_plain`` within atol
3e-5, and one-stage GPipe its sequential form. JAX is imported inside the
tests that use it, so the card's host (no JAX) collects the file
(``python -m pytest -m gpu tests/test_torch_lm_partitioning.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs.registry as TR
import repro_torch.models as TM
from repro_torch.sharding.compat import get_active_mesh, set_mesh, spec_placements
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    SP_RULES,
    MeshShape,
    PartitionSpec,
    axis_rules,
    current_rules,
    logical_constraint,
    logical_constraint_padded,
    logical_spec,
    param_sharding,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {
    "2x4": (("data", "model"), (2, 4)),
    "4x2": (("data", "model"), (4, 2)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


def _paths(tree, prefix=""):
    """``[(path, leaf)]`` of a nested dict in sorted key order (JAX's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def _jax_paths(tree):
    import jax

    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))[0]:
        out.append(("/".join(str(p.key) for p in path), leaf))
    return out


def _norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_logical_axes_equal_jax_for_every_arch(smoke):
    import repro.configs.registry as JR
    import repro.models as JM

    get_j = JR.get_smoke_config if smoke else JR.get_config
    get_t = TR.get_smoke_config if smoke else TR.get_config
    for arch in TR.ARCHS:
        mine = _paths(TM.param_logical_axes(get_t(arch)))
        theirs = _jax_paths(JM.param_logical_axes(get_j(arch)))
        assert mine == theirs, arch
        mine = _paths(TM.cache_logical_axes(get_t(arch), 2, 16))
        theirs = _jax_paths(JM.cache_logical_axes(get_j(arch), 2, 16))
        assert mine == theirs, arch


_JAX_SPECS = """
import json, sys, jax
from repro.configs.registry import ARCHS, get_config
from repro.models import init_params, param_logical_axes
from repro.sharding.compat import set_mesh
from repro.sharding.partitioning import DEFAULT_RULES, axis_rules, logical_spec, param_sharding

def norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]

meshes = json.loads(sys.argv[1])
shapes = {}
for a in ARCHS:
    cfg = get_config(a)
    sh = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0))
    shapes[a] = (jax.tree.leaves(param_logical_axes(cfg), is_leaf=lambda x: isinstance(x, tuple)),
                 [tuple(s.shape) for s in jax.tree.leaves(sh)])
out = {}
for key, (names, sizes) in meshes.items():
    mesh = jax.make_mesh(tuple(sizes), tuple(names))
    per = {}
    for a, (axes, shps) in shapes.items():
        rows = []
        with axis_rules(DEFAULT_RULES), set_mesh(mesh):
            for ax, s in zip(axes, shps):
                rows.append([norm(param_sharding(ax, mesh, DEFAULT_RULES, shape=s).spec),
                             norm(param_sharding(ax, mesh, DEFAULT_RULES).spec),
                             norm(logical_spec(ax, shape=s)), norm(logical_spec(ax))])
        per[a] = rows
    out[key] = per
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", _JAX_SPECS, json.dumps(MESHES)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_specs_equal_jax_for_every_leaf(mesh_key, jax_specs):
    names, sizes = MESHES[mesh_key]
    mesh = MeshShape(names, sizes)
    for arch in TR.ARCHS:
        cfg = TR.get_config(arch)
        axes = TM.tree_leaves(TM.param_logical_axes(cfg))
        shapes = [tuple(t.shape) for t in TM.tree_leaves(TM.init_params(0, cfg, device="meta"))]
        rows = []
        with axis_rules(DEFAULT_RULES):
            for ax, s in zip(axes, shapes):
                rows.append([_norm(param_sharding(ax, mesh, DEFAULT_RULES, shape=s).spec),
                             _norm(param_sharding(ax, mesh, DEFAULT_RULES).spec),
                             _norm(logical_spec(ax, shape=s, mesh=mesh)), _norm(logical_spec(ax, mesh=mesh))])
                spec_placements(param_sharding(ax, mesh, DEFAULT_RULES, shape=s).spec, mesh)  # a layout DTensor has
        assert rows == jax_specs[mesh_key][arch], (mesh_key, arch)


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m3 = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert spec_placements(PartitionSpec(("pod", "data"), "model"), m3) == (Shard(0), Shard(0), Shard(1))
    assert spec_placements(PartitionSpec(None, "model"), m3) == (Replicate(), Replicate(), Shard(1))
    assert spec_placements(PartitionSpec(), m3) == (Replicate(),) * 3
    # a one-name tuple reads as the name (JAX's normalization)
    assert PartitionSpec(("data",), None) == PartitionSpec("data", None) == ("data", None)
    # DTensor orders a dimension's axes by mesh dimension: a tuple against
    # the mesh's axis order, or an axis used twice, is refused
    with pytest.raises(ValueError, match="axis order"):
        spec_placements(PartitionSpec(("data", "pod")), m3)
    with pytest.raises(ValueError, match="twice"):
        spec_placements(PartitionSpec("data", "data"), m3)
    sh = param_sharding(("fsdp", "qkv"), m3, DEFAULT_RULES, shape=(8, 6))
    assert sh.spec == (("pod", "data"), "model") and sh.placements == (Shard(0), Shard(0), Shard(1))
    # a dimension that does not divide is dropped without using up the axis
    sh = param_sharding(("kv_heads", "kv_dim"), MeshShape(("data", "model"), (2, 16)), DEFAULT_RULES, shape=(8, 128))
    assert sh.spec == (None, "model")
    for rules in (DEFAULT_RULES, SP_RULES):
        for phys in rules.values():
            if isinstance(phys, tuple):
                spec_placements(PartitionSpec(phys), m3)  # every rule's tuple follows the mesh order


def test_axis_rules_and_set_mesh_nest():
    assert current_rules() is None and get_active_mesh() is None
    outer, inner = MeshShape(("data",), (2,)), MeshShape(("data", "model"), (2, 2))
    with axis_rules(DEFAULT_RULES), set_mesh(outer):
        assert current_rules() is DEFAULT_RULES and get_active_mesh() is outer
        with axis_rules(SP_RULES), set_mesh(inner):
            assert current_rules() is SP_RULES and get_active_mesh() is inner
            assert logical_spec(("batch", "seq")) == (None, "data")
        assert current_rules() is DEFAULT_RULES and get_active_mesh() is outer
        assert logical_spec(("batch", "seq")) == ("data",)
    assert current_rules() is None and get_active_mesh() is None


def test_constraints_are_no_ops_without_a_mesh():
    """No rules, rules without a mesh, or a plain tensor: the tensor comes
    back as it is; every smoke arch's forward under rules (no mesh) equals
    its forward without them bit for bit."""
    x = torch.randn(2, 3, 4)
    assert logical_constraint(x, "batch", "seq", "embed") is x
    with axis_rules(DEFAULT_RULES):
        assert logical_constraint(x, "batch", "seq", "embed") is x
        assert logical_constraint_padded(x, "batch", "seq", "heads") is x
        with set_mesh(MeshShape(("data", "model"), (1, 1))):
            assert logical_constraint(x, "batch", "seq", "embed") is x
    rng = np.random.default_rng(0)
    for arch in TR.ARCHS:
        cfg = TR.get_smoke_config(arch)
        params = TM.init_params(0, cfg, device="cpu")
        kw = {}
        if cfg.frontend == "audio":
            kw["embeds"] = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
        else:
            kw["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
        if cfg.frontend == "vision":
            kw["cross_ctx"] = torch.from_numpy(
                rng.standard_normal((2, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32))
        plain, _, aux = TM.forward(params, cfg, **kw)
        with axis_rules(DEFAULT_RULES):
            ruled, _, aux_r = TM.forward(params, cfg, **kw)
        assert torch.equal(plain, ruled) and torch.equal(aux, aux_r), arch


# ------------------------------------------------------ a group of one rank
@pytest.fixture
def world1():
    """A world-1 process group made in this process (``gloo`` on the CPU,
    ``nccl`` on the card), destroyed after the test."""
    made = []

    def make(backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        made.append(backend)

    yield make
    if made:
        dist.destroy_process_group()


def _mesh11(device_type):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


def test_trainer_resumes_onto_the_active_mesh(world1, tmp_path):
    """A checkpoint written without a mesh, resumed under ``set_mesh``: the
    state comes back as DTensors placed as ``train_state_shardings`` says,
    equal to the trainer's, and trains on."""
    import signal

    from repro_torch.checkpoint.elastic import train_state_shardings
    from repro_torch.data import lm_batches
    from repro_torch.train import OptConfig, Trainer

    world1("gloo")
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        cfg = TR.get_smoke_config("yi-6b")
        opt = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
        first = Trainer(cfg, opt, str(tmp_path), device="cpu")
        first.init_or_resume()
        first.run(lm_batches(cfg.vocab_size, 2, 8, 2, seed=0), max_steps=2)
        mesh = _mesh11("cpu")
        with axis_rules(DEFAULT_RULES), set_mesh(mesh):
            second = Trainer(cfg, opt, str(tmp_path), device="cpu")
            assert second.init_or_resume() == "resumed" and second.step == 2
            p_sh, o_sh = train_state_shardings(cfg, mesh)
            state = {"params": second.params, "opt": second.opt_state}
            for t, s in zip(TM.tree_leaves(state), TM.tree_leaves({"params": p_sh, "opt": o_sh})):
                assert type(t).__name__ == "DTensor" and tuple(t.placements) == s.placements
            for a, b in zip(TM.tree_leaves(second.params), TM.tree_leaves(first.params)):
                assert torch.equal(a.full_tensor(), b)
            m = second.run(lm_batches(cfg.vocab_size, 2, 8, 3, seed=2), max_steps=3)
        assert second.step == 3 and np.isfinite(m["loss"])
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    """The CUDA device with TF32 off (fp32 comparisons); skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_mesh_step_equals_no_mesh_on_card(cuda, world1):
    """stablelm's smoke config in bf16 with remat and two microbatches: one
    step on a (1, 1) mesh equals the step without one, loss, grad norm and
    every parameter bit for bit (tokens without repetition: no embedding
    row adds its gradients in an order set by atomics)."""
    from repro_torch.checkpoint.elastic import lay_out
    from repro_torch.launch.dryrun import _shard_tree
    from repro_torch.train import OptConfig, init_train_state, make_train_step

    world1("nccl")
    cfg = dataclasses.replace(TR.get_smoke_config("stablelm-1.6b"), act_dtype="bfloat16", remat="full", grad_accum=2)
    p0 = TM.init_params(0, cfg, device=cuda)
    perm = np.random.default_rng(5).permutation(cfg.vocab_size)
    batch = {"tokens": perm[:64].reshape(2, 32).astype(np.int32), "labels": perm[64:128].reshape(2, 32).astype(np.int32)}
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10))
    p1, _, m1 = step(p0, init_train_state(p0), batch)
    mesh = _mesh11("cuda")
    sh = _shard_tree(TM.param_logical_axes(cfg), mesh, DEFAULT_RULES, p0)
    with axis_rules(DEFAULT_RULES), set_mesh(mesh):
        s0 = init_train_state(p0)
        p2, _, m2 = step(lay_out(p0, sh), {"m": lay_out(s0["m"], sh), "v": lay_out(s0["v"], sh), "step": s0["step"]},
                         batch)
    assert float(m1["loss"]) == float(m2["loss"]) and float(m1["grad_norm"]) == float(m2["grad_norm"])
    for a, b in zip(TM.tree_leaves(p1), TM.tree_leaves(p2)):
        assert b.to_local().is_cuda and torch.equal(a, b.full_tensor())


@pytest.mark.gpu
def test_ring_attention_and_gpipe_on_card(cuda, world1):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import AttnSpec
    from repro_torch.models.attention import _sdpa_plain
    from repro_torch.sharding.pipeline_parallel import gpipe
    from repro_torch.sharding.ring_attention import ring_attention

    world1("nccl")
    ring = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 64, 4, 16), generator=g, device=cuda)
    k, v = (torch.randn((2, 64, 2, 16), generator=g, device=cuda) for _ in range(2))
    pos = torch.arange(64, dtype=torch.int32, device=cuda)[None].expand(2, 64)
    for spec, cap in [(AttnSpec(kind="global"), 0.0), (AttnSpec(kind="global", causal=False), 0.0),
                      (AttnSpec(kind="local", window=24), 0.0), (AttnSpec(kind="global"), 30.0)]:
        out = ring_attention(q, k, v, pos, spec, ring, axis="data", softcap=cap).full_tensor()
        assert out.is_cuda
        torch.testing.assert_close(out, _sdpa_plain(q, k, v, pos, pos, spec, cap), atol=3e-5, rtol=0)
    pipe = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    ws = torch.randn((1, 16, 16), generator=g, device=cuda) / 4.0
    xs = torch.randn((8, 2, 16), generator=g, device=cuda)
    out = gpipe(lambda w, x: torch.tanh(x @ w), ws, xs, pipe, axis="pipe").full_tensor()
    torch.testing.assert_close(out, torch.tanh(xs @ ws[0]), atol=1e-5, rtol=0)
