"""The port's LM serving (``repro_torch.serving.ServeEngine``, the samplers,
the launcher's ``serve_lm``) against the JAX package's, on the CPU with the
JAX parameters carried over by ``params_from_jax``; and, marked ``gpu``,
the port's models and engine on the CUDA card against the port on the CPU.

The engine cases are the JAX package's own (``tests/test_serving.py``:
batched equals sequential, slot reuse and admission, eos), each run once
through JAX's engine in a module-scoped fixture. JAX is imported inside the
fixtures only, so this file runs on the card's host, which has no JAX
(``python -m pytest -m gpu tests/test_torch_lm_serving.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch.configs.registry as TR
import repro_torch.models as TM
from repro_torch.serving import Request, ServeEngine, greedy, sample_temperature, sample_topk

YI = "yi-6b"
CASES = {
    "batched": dict(slots=3, prompts=[[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5]], max_tokens=6),
    "reuse": dict(slots=2, prompts=[[1, 2], [3, 4], [5, 6]], max_tokens=3),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, imported here so the card host (no JAX)
    can collect the file."""
    import jax
    import jax.numpy as jnp

    import repro.configs.registry as JR
    import repro.models as JM
    import repro.serving as JS

    return dataclasses.make_dataclass("JX", ["jax", "jnp", "JR", "JM", "JS"])(jax, jnp, JR, JM, JS)


@pytest.fixture(scope="module")
def yi_params(jx):
    """(JAX params of yi-6b smoke, the same as the port's CPU tensors)."""
    cfg = jx.JR.get_smoke_config(YI)
    jp = jx.jax.jit(lambda k: jx.JM.init_params(k, cfg))(jx.jax.random.PRNGKey(0))
    return jp, TM.params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")


def drive(engine_cls, request_cls, cfg, params, case, **kw):
    """Run one of ``CASES`` through an engine; returns (admissions, tokens,
    the engine). ``reuse`` submits two, is refused a third and a duplicate,
    runs, then takes the third into the freed slot."""
    eng = engine_cls(cfg, params, max_slots=case["slots"], max_len=64, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_tokens=case["max_tokens"]) for i, p in enumerate(case["prompts"])]
    admitted = []
    if case["slots"] >= len(reqs):
        admitted = [eng.submit(r) for r in reqs]
        eng.run_to_completion()
    else:
        admitted = [eng.submit(reqs[0]), eng.submit(reqs[1]), eng.submit(reqs[2]), eng.submit(reqs[0])]
        eng.run_to_completion()
        admitted.append(reqs[0].done and reqs[1].done)
        admitted.append(eng.submit(reqs[2]))
        eng.run_to_completion()
    return admitted, [r.generated for r in reqs], eng


@pytest.fixture(scope="module")
def jax_cases(jx, yi_params):
    cfg = jx.JR.get_smoke_config(YI)
    jp, _ = yi_params
    out = {name: drive(jx.JS.ServeEngine, jx.JS.Request, cfg, jp, case) for name, case in CASES.items()}
    first = out["batched"][1][0][0]
    eng = jx.JS.ServeEngine(cfg, jp, max_slots=1, max_len=64)
    r = jx.JS.Request(uid=0, prompt=[1, 2, 3, 4], max_tokens=50, eos_id=first)
    eng.submit(r)
    eng.run_to_completion()
    out["eos"] = (r.done, r.generated)
    return out


def standalone_greedy(cfg, params, prompt, n, device, max_len=64):
    caches = TM.init_caches(cfg, 1, max_len, device=device)
    lp, caches, _ = TM.forward(params, cfg, tokens=torch.tensor([prompt], device=device), mode="prefill",
                               caches=caches)
    out = [int(torch.argmax(lp[:, -1], -1)[0])]
    for pos in range(len(prompt), len(prompt) + n - 1):
        ld, caches, _ = TM.forward(params, cfg, tokens=torch.tensor([[out[-1]]], device=device),
                                   positions=torch.tensor([[pos]], dtype=torch.int32, device=device),
                                   mode="decode", caches=caches)
        out.append(int(torch.argmax(ld[:, 0], -1)[0]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(case, yi_params, jax_cases):
    """Same admissions, same tokens; batched equals each prompt decoded
    alone in the port too."""
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    admitted, tokens, _ = drive(ServeEngine, Request, cfg, params, CASES[case], device="cpu")
    assert admitted == jax_cases[case][0]
    assert tokens == jax_cases[case][1]
    for prompt, toks in zip(CASES[case]["prompts"], tokens):
        assert toks == standalone_greedy(cfg, params, prompt, len(toks), "cpu")


def test_engine_decodes_every_slot_as_jax(jx, yi_params, jax_cases):
    """JAX's engine decodes inactive slots too (the batch keeps its shape),
    so their cache rows move on; the port's caches after the reuse case
    equal JAX's leaf for leaf, positions and last tokens included."""
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    _, _, eng = drive(ServeEngine, Request, cfg, params, CASES["reuse"], device="cpu")
    jeng = jax_cases["reuse"][2]
    jc = jx.jax.tree.map(np.asarray, jeng.caches)
    mine = eng.caches["pattern"]["block0"]["attn"]
    theirs = jc["pattern"]["block0"]["attn"]
    assert np.array_equal(mine["pos"].numpy(), theirs["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(mine[name].numpy(), theirs[name], rtol=1e-4, atol=1e-4)
    assert eng.positions.tolist() == np.asarray(jeng.positions).tolist()
    assert eng.last_token.tolist() == np.asarray(jeng.last_token).tolist()


def test_eos_stops_early_as_jax(yi_params, jax_cases):
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    done, generated = jax_cases["eos"]
    eng = ServeEngine(cfg, params, max_slots=1, max_len=64, device="cpu")
    r = Request(uid=0, prompt=[1, 2, 3, 4], max_tokens=50, eos_id=generated[0])
    eng.submit(r)
    eng.run_to_completion()
    assert (r.done, r.generated) == (done, generated)
    assert r.done and len(r.generated) <= 3


def test_request_done_at_prefill_never_takes_a_slot(yi_params):
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    eng = ServeEngine(cfg, params, max_slots=1, max_len=64, device="cpu")
    r = Request(uid=0, prompt=[1, 2], max_tokens=1)
    assert eng.submit(r) and r.done and eng.active == [False]
    assert eng.step() == [r]
    assert eng.step() == []


def test_engine_wants_params_on_its_device(yi_params):
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    with pytest.raises((ValueError, RuntimeError)):
        ServeEngine(cfg, params)  # the card by default: none here, or params elsewhere


# ---------------------------------------------------------------- samplers
def test_greedy_is_jax_argmax(jx):
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 3, (64, 50)).astype(np.float32)  # many ties
    assert np.array_equal(greedy(torch.from_numpy(logits)).numpy(),
                          np.asarray(jx.JS.greedy(jx.jnp.asarray(logits))))


def test_topk_never_leaves_the_top_k():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 100, generator=gen)
    top = torch.topk(logits, 5, dim=-1).indices
    for _ in range(50):
        tok = sample_topk(logits, gen, k=5, temperature=2.0)
        assert bool((top == tok[:, None]).any(-1).all())


def test_temperature_near_zero_is_greedy_and_draws_are_seeded():
    logits = torch.randn(16, 300, generator=torch.Generator().manual_seed(1))
    assert torch.equal(sample_temperature(logits, torch.Generator().manual_seed(2), temperature=1e-6),
                       greedy(logits))
    assert torch.equal(sample_topk(logits, torch.Generator().manual_seed(2), k=40, temperature=0.0),
                       greedy(logits))
    a = sample_temperature(logits, torch.Generator().manual_seed(3))
    b = sample_temperature(logits, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_temperature_draws_follow_the_softmax():
    """Gumbel-max draws at temperature 1 land on each token about as often
    as its softmax probability (4000 draws of one row; 5 sigma)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(4000, 4)
    toks = sample_temperature(logits, torch.Generator().manual_seed(4))
    freq = torch.bincount(toks, minlength=4).double() / 4000
    p = torch.softmax(logits[0].double(), -1)
    assert torch.all((freq - p).abs() <= 5 * torch.sqrt(p * (1 - p) / 4000))


def test_engine_takes_a_bound_sampler(yi_params):
    cfg = TR.get_smoke_config(YI)
    _, params = yi_params
    sampler = functools.partial(sample_topk, generator=torch.Generator().manual_seed(5), k=3)
    eng = ServeEngine(cfg, params, max_slots=2, max_len=32, sampler=sampler, device="cpu")
    reqs = [Request(uid=i, prompt=[i, i + 1], max_tokens=5) for i in range(2)]
    assert all(eng.submit(r) for r in reqs)
    eng.run_to_completion()
    assert [len(r.generated) for r in reqs] == [5, 5]


# --------------------------------------------------------- the launcher
def test_serve_lm_serves_the_jax_launchers_mix(jx):
    """``serve_lm`` on the CPU at smoke size: the JAX launcher's request mix,
    every request finished with ``max_tokens`` tokens, and the tokens JAX's
    engine generates from the same (the port's seeded) parameters."""
    from repro_torch.launch.serve import serve_lm

    st = serve_lm(YI, smoke=True, slots=4, max_len=256, requests=8, max_tokens=16, device="cpu")
    cfg = TR.get_smoke_config(YI)
    assert st["prompts"] == [[(7 * i + j) % cfg.vocab_size for j in range(4 + i % 5)] for i in range(8)]
    assert [len(g) for g in st["generated"]] == [16] * 8
    assert st["tokens"] == 128 and st["steps"] == len(st["decode_ms"]) > 0
    assert len(st["prefill_ms"]) == 8 and st["max_memory_allocated"] is None
    params = jx.jax.tree.map(lambda t: jx.jnp.asarray(t.numpy()), TM.init_params(0, cfg, device="cpu"))
    eng = jx.JS.ServeEngine(jx.JR.get_smoke_config(YI), params, max_slots=4, max_len=256)
    reqs = [jx.JS.Request(uid=i, prompt=p, max_tokens=16) for i, p in enumerate(st["prompts"])]
    queue, done = list(reqs), 0
    while done < len(reqs):
        while queue and eng.submit(queue[0]):
            queue.pop(0)
        done += len(eng.step())
    assert [r.generated for r in reqs] == st["generated"]


def test_serve_lm_ckpt_dir_raises(tmp_path):
    """A directory without a checkpoint raises, as the JAX launcher's
    restore does (``--ckpt-dir`` is ported with the training slice; the
    restores themselves are in ``test_torch_checkpoint.py``)."""
    from repro_torch.launch.serve import serve_lm

    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        serve_lm(YI, smoke=True, device="cpu", ckpt_dir=str(tmp_path))


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    """The CUDA device with TF32 off (fp32 comparisons); skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    return torch.device("cuda", torch.cuda.current_device())


def close(a, b, tol=1e-4):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            close(a[k], b[k], tol)
        return
    np.testing.assert_allclose(a.detach().cpu().double().numpy(), b.detach().double().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-9b", "xlstm-350m", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "llama-3.2-vision-11b"])
def test_card_matches_cpu(arch, cuda):
    """The same port parameters and inputs on the card and on the CPU:
    train logits and aux, prefill logits and caches, one decode step, at
    the CPU tolerances (rtol/atol 1e-4)."""
    cfg = TR.get_smoke_config(arch)
    params = TM.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    kw = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))}
    if cfg.frontend == "vision":
        kw["cross_ctx"] = torch.from_numpy(rng.standard_normal((2, cfg.cross_attn_tokens, cfg.d_model))).float()
    on = {"cpu": (params, kw, torch.device("cpu")),
          "cuda": (TM.tree_map(lambda t: t.to(cuda), params), {k: v.to(cuda) for k, v in kw.items()}, cuda)}
    res = {}
    for where, (p, k, dev) in on.items():
        lt, _, aux = TM.forward(p, cfg, mode="train", **k)
        lp, caches, _ = TM.forward(p, cfg, mode="prefill", caches=TM.init_caches(cfg, 2, 32, device=dev), **k)
        nxt = torch.argmax(lp[:, -1], -1)[:, None]
        ld, c2, _ = TM.forward(p, cfg, mode="decode", caches=caches,
                               positions=torch.full((2, 1), 16, dtype=torch.int32, device=dev),
                               **dict(k, tokens=nxt))
        res[where] = {"train": lt, "aux": aux, "prefill": lp, "caches": caches, "decode": ld, "c2": c2,
                      "next": nxt}
    assert res["cuda"]["train"].is_cuda
    assert torch.equal(res["cuda"]["next"].cpu(), res["cpu"]["next"])
    close(res["cuda"], {k: v for k, v in res["cpu"].items()})


@pytest.mark.gpu
def test_engine_tokens_on_card_equal_cpu(cuda):
    cfg = TR.get_smoke_config(YI)
    params = TM.init_params(0, cfg, device="cpu")
    card = TM.tree_map(lambda t: t.to(cuda), params)
    for case in CASES.values():
        mine = drive(ServeEngine, Request, cfg, card, case, device=cuda)
        ref = drive(ServeEngine, Request, cfg, params, case, device="cpu")
        assert mine[:2] == ref[:2]
        assert mine[2].caches["pattern"]["block0"]["attn"]["k"].is_cuda
