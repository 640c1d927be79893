"""Batch sharding of the port (``repro_torch.sharding``, mesh plans) against
the JAX package's single-device output and the port's own single-device
plans, on the same numpy frames.

A ``BatchMesh`` of n ``"cpu"`` handles stands in for the JAX tests' forced
host-device count (``tests/test_bg_sharded.py``, ``XLA_FLAGS``): it drives
pad -> split -> dispatch -> gather -> trim in this process. The JAX mesh
tests fail on jax 0.9.0 (``shard_map`` lost ``check_rep``), so the oracle is
JAX's single-device output, which the JAX mesh contract promises bit for
bit (``src/repro/sharding/bg_shard.py``). Tolerances are the JAX package's:
fused atol 5e-3 and the quantized contract (>= 99.5 % equal, at most 1 LSB,
tests/test_kernels.py); bf16 across the packages atol 2.0 and 2 LSB
(tests/test_torch_precision.py); temporal carries atol 2e-2 / rtol 1e-3
(bf16: rtol 1.6e-2). Within the port every mesh output, carries too, equals
the single-device output bit for bit.

The tests marked ``gpu`` run B1, B3 and B2 through a mesh naming the card
twice at full HD and skip without a card:

    pytest -m gpu tests/test_torch_sharding.py
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.bg_denoise import PAPER_DEFAULT
from repro_torch.core import BGConfig, synthetic_image_np
from repro_torch.data import denoise_batch
from repro_torch.fleet import LocalWorker, PlanController
from repro_torch.kernels import launch_counts
from repro_torch.plan import BGPlan, plan_for
from repro_torch.serving import AsyncFrameEngine, FrameDenoiseEngine, FrameRequest
from repro_torch.sharding import BatchMesh, batch_mesh, bg_denoise_sharded, bg_temporal_sharded, shard_batch_call
from repro_torch.sharding.bg_shard import _pad_rows, _row_pad
from repro_torch.video import MultiStreamPacker, blurred_grid_batch, carry_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = (6, 4.0, 60.0)
CFG = BGConfig(*ARGS)
H, W = 45, 55  # ragged against r on both axes, as tests/test_bg_sharded.py
# the JAX package's (b, n_dev) shape classes, tests/test_bg_sharded.py:51
CLASSES = [(8, 8), (5, 4), (6, 8), (3, 8), (1, 8), (1, 1), (7, 2)]
ALPHAS = np.asarray([0.0, 0.6, 0.0, 0.4, 0.8, 0.0, 0.3, 0.5], np.float32)  # 0: a cold row
TOL = {"fp32": dict(img=5e-3, lsb=1.0, carry=dict(atol=2e-2, rtol=1e-3)),
       "bf16": dict(img=2.0, lsb=2.0, carry=dict(atol=2e-2, rtol=1.6e-2))}


def cpu_mesh(n):
    return BatchMesh(("cpu",) * n)


def noisy(b, h=H, w=W, seed=0):
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 50).normal(0.0, 30.0, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def quantized_contract(a, b, lsb=1.0):
    diff = np.abs(f32(a).astype(np.float64) - f32(b))
    assert diff.max() <= lsb, diff.max()
    if lsb == 1.0:
        assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)


X8 = noisy(8)


def mixed_carry(precision):
    """Warm carries (the blurred grids of other frames) on the rows whose
    alpha is above 0, zero carries on the cold rows; bf16 values for a bf16
    plan, so both packages read the same carry."""
    warm = blurred_grid_batch(torch.from_numpy(noisy(8, seed=90)), CFG)
    warm = warm * torch.from_numpy((ALPHAS > 0).astype(np.float32)).reshape(-1, 1, 1, 1, 1)
    if precision == "bf16":
        warm = warm.to(torch.bfloat16).to(torch.float32)
    return warm.numpy()


@pytest.fixture(scope="module")
def jref():
    """JAX's single-device outputs on the 8 frames (interpret mode), per
    precision: per frame (unquantized and quantized) and temporal on the
    mixed pack (image and carry). Per-frame outputs do not depend on the
    batch, so each shape class reads its first b rows."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import BGConfig as JBGConfig
    from repro.core.bilateral_grid import quantize_intensity as jquant
    from repro.plan import BGPlan as JBGPlan

    jcfg = JBGConfig(*ARGS)
    out = {}
    for prec in ("fp32", "bf16"):
        frame = np.asarray(JBGPlan(cfg=jcfg, backend="fused", quantize_output=False, precision=prec,
                                   interpret=True)(jnp.asarray(X8)), np.float32)
        tplan = JBGPlan(cfg=jcfg, backend="fused", temporal=True, quantize_output=False,
                        precision=prec, interpret=True)
        img, carry = tplan(jnp.asarray(X8), carry=jnp.asarray(mixed_carry(prec)).astype(tplan.storage_dtype),
                           alpha=ALPHAS)
        out[prec] = SimpleNamespace(frame=frame, quant=np.asarray(jquant(jnp.asarray(frame), jcfg)),
                                    img=f32(img), carry=f32(carry))
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# ------------------------------------------------------------- shape classes
@pytest.mark.parametrize("b,nd", CLASSES, ids=[f"b{b}-nd{nd}" for b, nd in CLASSES])
def test_shape_class_matches_jax_and_the_single_device_plan(jref, b, nd):
    """Every route that shards, fp32 and bf16, over a mesh of ``nd`` CPU
    handles on ``b`` frames (ragged, b < nd, b == 1): bit for bit the port's
    single-device plan, and within the reference tolerances of JAX's
    single-device output. The temporal pack mixes cold rows (zero carry,
    alpha 0) and warm ones; its carries are equal bit for bit too."""
    x = X8[:b]
    mesh = cpu_mesh(nd)
    for prec in ("fp32", "bf16"):
        ref, tol = jref[prec], TOL[prec]
        for backend in ("fused", "fused_streamed"):
            for quant in (False, True):
                kw = dict(cfg=CFG, backend=backend, quantize_output=quant, precision=prec)
                single = BGPlan(device="cpu", **kw)(x)
                plan = BGPlan(mesh=mesh, **kw)
                assert plan.mesh_size == nd and plan.device.type == "cpu"
                out = plan(x)
                assert out.dtype == torch.float32 and torch.equal(out, single), (prec, backend, quant)
                if quant:
                    quantized_contract(out, ref.quant[:b], tol["lsb"])
                else:
                    np.testing.assert_allclose(f32(out), ref.frame[:b], atol=tol["img"], rtol=0)
        carry, alpha = mixed_carry(prec)[:b], ALPHAS[:b]
        kw = dict(cfg=CFG, backend="fused", temporal=True, quantize_output=False, precision=prec)
        s_img, s_carry = BGPlan(device="cpu", **kw)(x, carry=carry, alpha=alpha)
        img, new_carry = BGPlan(mesh=mesh, **kw)(x, carry=carry, alpha=alpha)
        assert torch.equal(img, s_img) and torch.equal(new_carry, s_carry), prec
        assert new_carry.dtype == (torch.bfloat16 if prec == "bf16" else torch.float32)
        np.testing.assert_allclose(f32(img), ref.img[:b], atol=tol["img"], rtol=0)
        np.testing.assert_allclose(f32(new_carry), ref.carry[:b], **tol["carry"])


@pytest.mark.parametrize("nd", [2, 3, 8])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_temporal_1_vs_n_handles(nd, prec):
    """The JAX package's 1-vs-8-device temporal contract
    (tests/test_temporal_fused.py:269-300), held bit for bit: 5 streams
    (ragged on 2 and 8 handles), two chained steps on a mixed cold and warm
    pack, through ``bg_temporal_sharded`` and through a packer whose plan
    carries the mesh; cold rows equal the per-frame plan bit for bit."""
    n = 5
    carry, alpha = mixed_carry(prec)[:n], ALPHAS[:n]
    many = cpu_mesh(nd)
    kw = dict(cfg=CFG, temporal=True, quantize_output=False, precision=prec)
    for step in range(2):
        x = noisy(n, seed=7 * step)
        # a 1-handle mesh is the plain call (JAX: batch_mesh(1))
        ref_o, ref_c = bg_temporal_sharded(x, carry, alpha, plan=BGPlan(mesh=BatchMesh(("cpu",)), **kw))
        out, new_c = bg_temporal_sharded(x, carry, alpha, plan=BGPlan(mesh=many, **kw))
        assert torch.equal(out, ref_o) and torch.equal(new_c, ref_c)
        carry = new_c
    if prec == "fp32":  # the legacy keyword form builds the same mesh plan
        out, _ = bg_temporal_sharded(x, carry, alpha, CFG, mesh=many)
        assert torch.equal(out, BGPlan(mesh=many, **kw)(x, carry=carry, alpha=alpha)[0])
    per_frame = BGPlan(CFG, precision=prec, device="cpu")
    packs = {}
    for mesh in (None, many):
        base = BGPlan(CFG, precision=prec, device="cpu" if mesh is None else None, mesh=mesh)
        packer = MultiStreamPacker(plan=base)
        for s in range(n):
            packer.open(s, alpha=float(ALPHAS[s]))
        packs[mesh] = [packer.pack({s: f for s, f in enumerate(noisy(n, seed=11 * t))}) for t in range(2)]
        cold = [s for s in range(n) if ALPHAS[s] == 0.0]
        for t in range(2):
            ref = per_frame(noisy(n, seed=11 * t))
            assert all(torch.equal(packs[mesh][t][s], ref[s]) for s in cold)
    for t in range(2):
        assert all(torch.equal(packs[None][t][s], packs[many][t][s]) for s in range(n))


# ---------------------------------------------------------------- plan layer
def test_mesh_plan_validation():
    """A size-1 mesh is its device; a backend that does not shard raises;
    the plan's device is the mesh's first; the mesh size reaches the
    payload, ``describe()`` and the tile clamp (JAX src/repro/plan.py:494-537)."""
    assert BGPlan(CFG, mesh=BatchMesh(("cpu",))).mesh is None
    for backend in ("reference", "staged"):
        with pytest.raises(ValueError, match="does not shard"):
            BGPlan(CFG, backend=backend, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="first device"):
        BGPlan(CFG, mesh=cpu_mesh(2), device="cuda:0")
    with pytest.raises(TypeError, match="BatchMesh"):
        BGPlan(CFG, mesh=("cpu", "cpu"), device="cpu")
    with pytest.raises(ValueError, match="1-D batch"):
        BatchMesh(("cpu",), axis_names=("x",))
    plan = BGPlan(CFG, batch_tile=3, mesh=cpu_mesh(4))
    assert (plan.tile_for(8), plan.tile_for(16), plan.tile_for(5)) == (2, 3, 2)
    assert BGPlan(CFG, mesh=cpu_mesh(4)).tile_for(10) == 3
    assert plan.to_json()["mesh_size"] == 4 and "mesh=4" in plan.describe()
    assert plan.input_device is None and BGPlan(CFG, device="cpu").input_device.type == "cpu"
    ladder = BGPlan(CFG, backend="fused_streamed", mesh=cpu_mesh(2)).fallback_ladder()
    assert [(p.backend, p.mesh_size) for p in ladder] == [("fused_streamed", 2), ("fused", 2), ("reference", 1)]
    assert _row_pad(4, 5) == 3 and _row_pad(4, 8) == 0 and _row_pad(8, 1) == 7
    assert tuple(_pad_rows(torch.ones(2, 3), 2).sum(1)) == (3.0, 3.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="not in"):
        batch_mesh(torch.cuda.device_count() + 1)


def test_plan_for_divisibility_and_oracle_backends():
    """``plan_for``'s ``batch_tile > shard`` ``ValueError`` (JAX
    tests/test_plan.py:315), the cost model on the per-device shard, and the
    backends that do not shard staying on one device (``:366``)."""
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="mesh devices"):
        plan_for(CFG, H, W, n_frames=8, batch_tile=4, mesh=mesh)
    assert plan_for(CFG, H, W, n_frames=8, batch_tile=2, mesh=mesh).batch_tile == 2
    auto = plan_for(CFG, H, W, n_frames=8, mesh=mesh, cache=False)
    assert auto.mesh_size == 4 and auto.batch_tile <= 2 and auto.provenance == "model"
    for kw in (dict(backend="reference"), dict(backend="staged"), dict(temporal=True, backend="reference")):
        assert plan_for(CFG, H, W, device="cpu", sharded=None, **kw).mesh is None
    with pytest.raises(ValueError, match="does not shard"):
        plan_for(CFG, H, W, backend="staged", mesh=mesh)
    with pytest.raises(ValueError, match="mesh-capable"):
        plan_for(CFG, H, W, backend="staged", sharded=True, device="cpu")


def test_from_json_binds_a_mesh():
    """``mesh="auto"`` wants the payload's cards and raises with too few; an
    explicit mesh rebinds; ``mesh=None`` is one device; the port's payload
    round-trips (JAX src/repro/plan.py:599-628)."""
    plan = BGPlan(CFG, batch_tile=2, mesh=cpu_mesh(2))
    payload = json.loads(json.dumps(plan.to_json()))
    assert payload["mesh_size"] == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="2-device mesh"):
            BGPlan.from_json(payload)
    assert BGPlan.from_json(payload, mesh=cpu_mesh(2)) == plan
    assert BGPlan.from_json(payload, mesh=cpu_mesh(2)).plan_hash() == plan.plan_hash()
    single = BGPlan.from_json(payload, mesh=None, device="cpu")
    assert single.mesh is None and single.plan_hash() != plan.plan_hash()


def test_mesh_payload_hashes_as_jax():
    """A ``mesh_size=2`` payload hashes as the JAX package's: its plan is
    built in a child with two forced host devices (a mesh, never a
    ``shard_map``), and the port rebinds the payload to a CPU mesh."""
    pytest.importorskip("jax")
    code = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'\n"
        "import json\n"
        "from repro.core import BGConfig\n"
        "from repro.plan import BGPlan\n"
        "from repro.sharding.bg_shard import batch_mesh\n"
        "out = []\n"
        "for kw in (dict(backend='fused', batch_tile=2), dict(backend='fused_streamed'),\n"
        "           dict(backend='fused', temporal=True, precision='bf16')):\n"
        f"    p = BGPlan(cfg=BGConfig{ARGS!r}, mesh=batch_mesh(2), **kw)\n"
        "    out.append([p.to_json(), p.plan_hash()])\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for payload, want in json.loads(proc.stdout.strip().splitlines()[-1]):
        assert payload["mesh_size"] == 2
        plan = BGPlan.from_json(payload, mesh=cpu_mesh(2))
        assert plan.mesh_size == 2 and plan.plan_hash() == want
        assert plan.to_json() == payload


# ---------------------------------------------------------------- entry points
def test_frame_engine_micro_batches_mesh_divisible():
    """The frame engine on a 4-handle mesh (JAX
    tests/test_bg_sharded.py:85-117): ``max_batch`` rounds down to a mesh
    multiple but never below the device count, ``step()`` dispatches only
    divisible counts, the forced ragged tail is padded, and every result
    equals the single-device plan's bit for bit."""
    mesh = cpu_mesh(4)
    assert FrameDenoiseEngine(CFG, max_batch=10, device="cpu", mesh=mesh).max_batch == 8
    assert FrameDenoiseEngine(CFG, max_batch=3, device="cpu", mesh=mesh).max_batch == 4
    frames = noisy(11, 40, 48, seed=4)
    ref = BGPlan(CFG, device="cpu")(frames)
    eng = FrameDenoiseEngine(CFG, max_batch=8, device="cpu", mesh=mesh)
    assert (eng.n_devices, eng.max_batch, eng.mesh) == (4, 8, mesh)
    done, sizes = [], []
    for i in range(11):
        eng.submit(FrameRequest(uid=i, frame=frames[i]))
        batch = eng.step()
        if batch:
            sizes.append(len(batch))
        done.extend(batch)
    assert sizes == [4, 4] and eng.pending() == 3 and eng.step() == []
    done.extend(eng.flush())
    assert len(done) == 11 and eng.pending() == 0
    assert all(torch.equal(r.result, ref[r.uid]) for r in done)
    with pytest.raises(ValueError, match="mesh="):
        FrameDenoiseEngine(plan=eng.plan, mesh=mesh)


def test_async_engine_and_packer_equal_their_single_device_runs():
    """``AsyncFrameEngine`` on a 2-handle mesh (``mesh=`` on the legacy
    constructor), per frame and in video mode through a mesh packer: every
    result equals the single-device run's bit for bit."""
    frames = noisy(6, seed=21)
    runs = {}
    for mesh in (None, cpu_mesh(2)):
        with AsyncFrameEngine(CFG, max_batch=3, batch_window_ms=1.0, device="cpu", mesh=mesh) as eng:
            assert eng.plan.mesh == mesh
            runs[mesh, "frames"] = [f.result(timeout=60) for f in [eng.submit(x) for x in frames]]
        packer = MultiStreamPacker(CFG, device="cpu", mesh=mesh)
        for s in range(3):
            packer.open(s, alpha=(0.0, 0.6, 0.4)[s])
        with AsyncFrameEngine(packer=packer, max_batch=3, batch_window_ms=1.0) as eng:
            futs = [eng.submit(frames[t], stream_id=t % 3) for t in range(6)]
            runs[mesh, "video"] = [f.result(timeout=60) for f in futs]
        runs[mesh, "carries"] = packer.export_carries()
    for kind in ("frames", "video"):
        assert all(torch.equal(a, b) for a, b in zip(runs[None, kind], runs[cpu_mesh(2), kind]))
    one, two = runs[None, "carries"], runs[cpu_mesh(2), "carries"]
    assert one.keys() == two.keys() == {1, 2}
    assert all(np.array_equal(one[s][0], two[s][0]) for s in one)


def test_denoise_batch_streaming_and_shims():
    """``denoise_batch(sharded=True, mesh=)``, the ``"streaming"`` plan,
    ``bg_denoise_sharded`` (single frame too) and ``shard_batch_call`` on a
    3-handle mesh, each equal to its single-device call bit for bit."""
    mesh = cpu_mesh(3)
    x = noisy(4)
    fused = BGPlan(CFG, device="cpu")(x)
    assert torch.equal(denoise_batch(x, CFG, sharded=True, mesh=mesh), fused)
    streaming = BGPlan(CFG, backend="streaming", device="cpu")
    assert torch.equal(BGPlan(CFG, backend="streaming", mesh=mesh)(x), streaming(x))
    assert torch.equal(BGPlan(CFG, backend="streaming", mesh=mesh)(x[0]), streaming(x[0]))
    raw = BGPlan(CFG, quantize_output=False, device="cpu")
    assert torch.equal(bg_denoise_sharded(x, CFG, mesh=mesh), raw(x))
    assert torch.equal(bg_denoise_sharded(x[1], CFG, mesh=mesh, stream_input=True), raw(x[1]))
    assert torch.equal(shard_batch_call(lambda t: t * 2.0 + 1.0, x, mesh), torch.from_numpy(x) * 2.0 + 1.0)
    color = np.stack([x[:2], x[2:]], axis=-1)  # (2, h, w, 2): channels fold into the batch
    assert torch.equal(BGPlan(CFG, mesh=mesh)(color), BGPlan(CFG, device="cpu")(color))


def test_local_worker_loads_a_mesh_payload():
    """A ``LocalWorker`` given a ``mesh_size=2`` controller payload and an
    explicit 2-handle mesh serves a warm stream as a one-device worker does,
    bit for bit; the controller's ``bless`` key carries the mesh size."""
    mesh = cpu_mesh(2)
    ctl = PlanController(BGPlan(CFG, temporal=True, mesh=mesh))
    assert ctl.payload()["plan"]["mesh_size"] == 2
    single = PlanController(BGPlan(CFG, temporal=True, device="cpu"))
    frames = noisy(3, seed=33)
    outs = []
    for payload, kw in ((ctl.payload(), dict(mesh=mesh)), (single.payload(), dict(device="cpu"))):
        w = LocalWorker(0, payload, **kw)
        try:
            w.open_stream("s", alpha=0.6)
            outs.append([w.submit(f, stream_id="s").result(timeout=60) for f in frames])
        finally:
            w.close()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    from repro_torch.fleet import SubprocessWorker

    with pytest.raises(ValueError, match="mesh='auto'"):
        SubprocessWorker(0, ctl.payload(), mesh=mesh)


def test_denoise_stream_example_shards_on_a_repeated_mesh():
    from repro_torch.examples import denoise_stream

    st = denoise_stream.main(["--device", "cpu", "--height", "36", "--width", "48", "--frames", "3",
                              "--mesh", "2"])
    assert st["sharded"]["mesh_size"] == 2 and st["sharded"]["bitwise_batched"]


# ------------------------------------------------------------------- the card
def _card_frames(b, dev):
    gen = torch.Generator(device=dev).manual_seed(b)
    return torch.floor(torch.rand((b, 1080, 1920), generator=gen, device=dev) * 256.0)


def _counted(fn):
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("backend,counter", [("fused", "bg_fused.launches"),
                                             ("fused_streamed", "bg_fused.streamed_launches")])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_card_mesh_twice_bitwise(cuda, backend, counter, prec):
    """B1 and B3 (fp32 and bf16) through a mesh naming the card twice, on 8
    full-HD frames at ``PAPER_DEFAULT``: equal to the single-device call bit
    for bit, one launch per shard (2 per dispatch)."""
    cfg = PAPER_DEFAULT.bg
    x = _card_frames(8, cuda)
    kw = dict(cfg=cfg, backend=backend, precision=prec)
    single, _ = _counted(lambda: BGPlan(device=cuda, **kw)(x))
    out, got = _counted(lambda: BGPlan(mesh=BatchMesh((cuda, cuda)), **kw)(x))
    want = counter.replace("bg_fused.", "bg_fused.bf16_") if prec == "bf16" else counter
    assert torch.equal(out, single) and out.device == cuda
    assert got == {want: 2}, got


@pytest.mark.gpu
def test_card_mesh_twice_temporal_bitwise(cuda):
    """B2 through a mesh naming the card twice: a 4-stream pack, cold then
    warm, image and carry equal to the single-device call bit for bit, one
    launch per shard."""
    cfg = PAPER_DEFAULT.bg
    mesh = BatchMesh((cuda, cuda))
    alpha = torch.tensor([0.0, 0.6, 0.4, 0.8], device=cuda)
    single = BGPlan(cfg, temporal=True, device=cuda)
    meshed = BGPlan(cfg, temporal=True, mesh=mesh)
    carry = torch.zeros((4,) + carry_shape(1080, 1920, cfg), device=cuda)
    for step in range(2):
        x = _card_frames(4, cuda) + step
        (s_img, s_carry), _ = _counted(lambda: single(x, carry=carry, alpha=alpha))
        (img, new_carry), got = _counted(lambda: meshed(x, carry=carry, alpha=alpha))
        assert torch.equal(img, s_img) and torch.equal(new_carry, s_carry)
        assert got == {"bg_fused.temporal_launches": 2}, got
        carry = new_carry
