"""The port's measured-plan cache (``repro_torch.plan_cache``): the cases of
tests/test_plan_cache.py on CPU plans, plus files shared with the JAX
package's cache (one format; each package's entries inert in the other).

An autouse fixture points the port's default cache at a file under
``tmp_path``; most cases pin their own ``PlanCache`` anyway.
"""
import json

import pytest

from repro.core import BGConfig as JBGConfig
from repro.plan import BGPlan as JBGPlan
from repro.plan import plan_for as jplan_for
from repro.plan_cache import PlanCache as JPlanCache
from repro.plan_cache import host_fingerprint as jhost_fingerprint
from repro.plan_cache import merge_caches as jmerge_caches
from repro.plan_cache import workload_key as jworkload_key
from repro_torch.core import BGConfig
from repro_torch.plan import BGPlan, plan_for
from repro_torch.plan_cache import (
    CACHE_ENV_VAR,
    CACHE_VERSION,
    PlanCache,
    get_default_cache,
    host_fingerprint,
    merge_caches,
    set_default_cache,
    workload_key,
)

ARGS = (4, 3.0, 50.0)
CFG, JCFG = BGConfig(*ARGS), JBGConfig(*ARGS)
H, W, B = 60, 96, 8


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV_VAR, str(tmp_path / "default_cache.json"))
    set_default_cache(None)
    yield
    set_default_cache(None)


def _key(n_frames=B, temporal=False, mesh_size=1):
    return workload_key(CFG, H, W, n_frames, temporal, mesh_size, device="cpu")


def _plan(**kw):
    return BGPlan(cfg=CFG, device="cpu", **kw)


def _plan_for(**kw):
    return plan_for(CFG, H, W, device="cpu", **kw)


def test_record_lookup_round_trip(tmp_path):
    pc = PlanCache(str(tmp_path / "cache.json"))
    assert len(pc) == 0 and pc.lookup(_key()) is None
    plan = _plan(backend="fused", batch_tile=2)
    pc.record(_key(), plan, measured_us=123.4, model_us=150.0)
    pc2 = PlanCache(str(tmp_path / "cache.json"))  # re-reads the file
    ent = pc2.lookup(_key())
    assert ent is not None
    assert ent["plan_hash"] == plan.plan_hash()
    assert ent["measured_us"] == 123.4 and ent["source"] == "sweep"
    assert BGPlan.from_json(ent["plan"], device="cpu") == plan
    data = json.loads((tmp_path / "cache.json").read_text())
    assert data["version"] == CACHE_VERSION
    assert _key() in data["entries"]


def test_plan_for_consults_cache_before_model(tmp_path):
    pc = PlanCache(str(tmp_path / "cache.json"))
    model_pick = _plan_for(n_frames=B, cache=False)
    assert model_pick.provenance == "model"
    # tile 1 never wins the model for a multi-frame pack (launch overhead)
    winner = _plan(backend="fused", batch_tile=1)
    assert winner.batch_tile != model_pick.batch_tile
    pc.record(_key(), winner, measured_us=1.0)
    hit = _plan_for(n_frames=B, cache=pc)
    assert hit.provenance == "cache"
    assert hit.batch_tile == 1 and hit.backend == "fused" and hit == winner
    assert "src=cache" in hit.describe()
    bypass = _plan_for(n_frames=B, cache=False)
    assert bypass.provenance == "model" and bypass == model_pick
    # a pinned argument: the cache must not override it
    pinned = _plan_for(n_frames=B, batch_tile=4, cache=pc)
    assert pinned.provenance == "model" and pinned.batch_tile == 4
    fully_pinned = _plan_for(backend="fused", batch_tile=4, cache=pc)
    assert fully_pinned.provenance == "explicit"


def test_default_cache_follows_env(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV_VAR, str(tmp_path / "env_cache.json"))
    set_default_cache(None)
    pc = get_default_cache()
    assert pc.path == str(tmp_path / "env_cache.json")
    pc.record(_key(), _plan(backend="fused", batch_tile=1))
    hit = _plan_for(n_frames=B)  # cache=None: the env-pointed default
    assert hit.provenance == "cache" and hit.batch_tile == 1
    # the port's own variable and path: the JAX package's never leak in
    assert CACHE_ENV_VAR == "REPRO_TORCH_PLAN_CACHE"
    monkeypatch.delenv(CACHE_ENV_VAR)
    from repro_torch.plan_cache import default_cache_path

    assert default_cache_path().endswith("/.cache/repro_torch/bg_plan_cache.json")


def test_corrupt_cache_tolerated(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json at all")
    pc = PlanCache(str(path))
    with pytest.warns(UserWarning, match="unreadable"):
        assert pc.lookup(_key()) is None
    pc.record(_key(), _plan(backend="fused", batch_tile=2))
    assert PlanCache(str(path)).lookup(_key()) is not None
    path2 = tmp_path / "future.json"
    path2.write_text(json.dumps({"version": 99, "entries": {"x": {}}}))
    pc2 = PlanCache(str(path2))
    with pytest.warns(UserWarning, match="unrecognized"):
        assert pc2.lookup(_key()) is None
    assert _plan_for(n_frames=B, cache=pc2).provenance == "model"


def test_foreign_host_entries_never_match(tmp_path):
    pc = PlanCache(str(tmp_path / "cache.json"))
    fp = host_fingerprint("cpu")
    foreign = _key().replace(fp, "sparc64-torch0-cuda-X-sm10", 1)
    assert foreign != _key()
    pc.record(foreign, _plan(backend="fused", batch_tile=1))
    assert _plan_for(n_frames=B, cache=pc).provenance == "model"


def test_incompatible_cached_backend_falls_back_to_model(tmp_path):
    pc = PlanCache(str(tmp_path / "cache.json"))
    # a streamed winner under the temporal key is illegal there
    pc.record(_key(temporal=True), _plan(backend="fused_streamed", batch_tile=2))
    got = _plan_for(n_frames=B, temporal=True, cache=pc)
    assert got.provenance == "model" and got.backend != "fused_streamed"


def test_cached_bf16_plan_needs_precision_opt_in(tmp_path):
    pc = PlanCache(str(tmp_path / "cache.json"))
    pc.record(_key(), _plan(backend="fused", batch_tile=1, precision="bf16"), measured_us=1.0)
    got = _plan_for(n_frames=B, cache=pc)
    assert got.provenance == "model" and got.precision == "fp32"
    hit = _plan_for(n_frames=B, cache=pc, precision="auto")
    assert hit.provenance == "cache" and hit.precision == "bf16" and hit.batch_tile == 1
    assert pc.lookup(_key())["plan"]["precision"] == "bf16"
    pc.record(_key(), _plan(backend="fused", batch_tile=1), measured_us=1.0)
    legacy = _plan_for(n_frames=B, cache=pc)
    assert legacy.provenance == "cache" and legacy.precision == "fp32"


def test_old_schema_file_loads_and_stale_schema_prunes(tmp_path):
    import warnings

    path = tmp_path / "cache.json"
    pc = PlanCache(str(path))
    pc.record(_key(), _plan(backend="fused", batch_tile=2), measured_us=10.0)
    data = json.loads(path.read_text())
    old_key = "v1|" + _key().split("|", 1)[1]
    data["entries"][old_key] = dict(data["entries"][_key()])
    data["version"] = 1
    path.write_text(json.dumps(data))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pc2 = PlanCache(str(path))
        assert len(pc2) == 2
        assert pc2.lookup(old_key) is not None
    assert _key().startswith(f"v{CACHE_VERSION}|") and CACHE_VERSION > 1
    assert pc2.prune(stale_schema=True) == [old_key]
    assert pc2.lookup(_key()) is not None
    with pytest.raises(ValueError, match="prune needs"):
        pc2.prune()


def test_calibration_round_trip_and_merge(tmp_path):
    a = PlanCache(str(tmp_path / "a.json"))
    fp = host_fingerprint("cpu")
    assert a.calibration(fp) is None
    a.record(_key(), _plan(backend="fused", batch_tile=2), measured_us=5.0)
    a.record_calibration(fp, {"launch_overhead_s": 2e-5, "n_rows": 12})
    a2 = PlanCache(str(tmp_path / "a.json"))
    assert a2.calibration(fp)["constants"]["launch_overhead_s"] == 2e-5
    a2.record(_key(temporal=True), _plan(backend="fused", batch_tile=1))
    assert PlanCache(str(tmp_path / "a.json")).calibration(fp) is not None
    b = PlanCache(str(tmp_path / "b.json"))
    b.record_calibration(fp, {"launch_overhead_s": 9e-5})
    b.record_calibration("other-torch0-cpu", {"launch_overhead_s": 1e-6})
    merged = merge_caches(str(tmp_path / "o.json"), [str(tmp_path / "a.json"), str(tmp_path / "b.json")])
    assert merged.calibration(fp)["constants"]["launch_overhead_s"] == 9e-5
    assert merged.calibration("other-torch0-cpu") is not None
    merged.record(_key(), _plan(backend="fused", batch_tile=2))
    merged.prune(foreign=True)
    assert merged.calibration(fp) is not None


def test_cli_stale_schema_and_calibration_inspect(tmp_path, capsys):
    from repro_torch.plan_cache import main

    p = tmp_path / "c.json"
    pc = PlanCache(str(p))
    pc.record(_key(), _plan(backend="fused", batch_tile=2, precision="bf16"), measured_us=7.0)
    pc.record_calibration(host_fingerprint("cpu"), {"launch_overhead_s": 3e-6})
    data = json.loads(p.read_text())
    data["entries"]["v1|old|k"] = {"plan": {"backend": "fused"}, "plan_hash": "x"}
    p.write_text(json.dumps(data))
    assert main(["inspect", str(p)]) == 0
    out = capsys.readouterr().out
    assert "prec=bf16" in out and "calibration" in out
    assert main(["prune", str(p), "--stale-schema"]) == 0
    assert "removed 1" in capsys.readouterr().out
    assert set(PlanCache(str(p)).entries()) == {_key()}


def test_workload_key_separates_workloads():
    keys = {
        _key(),
        _key(n_frames=None),
        _key(temporal=True),
        _key(mesh_size=8),
        workload_key(CFG, H + 1, W, B, False, 1, device="cpu"),
        workload_key(BGConfig(r=8, sigma_s=3.0, sigma_r=50.0), H, W, B, False, 1, device="cpu"),
    }
    assert len(keys) == 6
    assert all(host_fingerprint("cpu") in k for k in keys)
    # the torch fingerprint: machine, torch version, device
    import torch

    fp = host_fingerprint("cpu")
    assert f"torch{torch.__version__}" in fp and fp.endswith("cpu") and "|" not in fp


def _seed_cache(path, key, batch_tile=2, measured_us=None, recorded=None):
    pc = PlanCache(str(path))
    ent = pc.record(key, _plan(backend="fused", batch_tile=batch_tile), measured_us=measured_us)
    if recorded is not None:  # backdate for the age cases
        data = json.loads(path.read_text())
        data["entries"][key]["recorded"] = recorded
        path.write_text(json.dumps(data))
    return ent


def test_cli_inspect(tmp_path, capsys):
    from repro_torch.plan_cache import main

    p = tmp_path / "c.json"
    _seed_cache(p, _key(), measured_us=88.5)
    assert main(["inspect", str(p)]) == 0
    out = capsys.readouterr().out
    assert "1 entry" in out and _key() in out
    assert "backend=fused" in out and "measured_us=88.5" in out
    assert main(["inspect", str(p), "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["version"] == CACHE_VERSION and _key() in data["entries"]


def test_cli_merge_prefers_fastest_measurement(tmp_path, capsys):
    from repro_torch.plan_cache import main

    a, b, out = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "o.json"
    _seed_cache(a, _key(), batch_tile=2, measured_us=120.0)
    _seed_cache(b, _key(), batch_tile=4, measured_us=80.0)  # the winner
    _seed_cache(b, _key(temporal=True), batch_tile=2, measured_us=55.0)
    assert main(["merge", str(out), str(a), str(b)]) == 0
    assert "2 entries" in capsys.readouterr().out
    merged = PlanCache(str(out))
    assert len(merged) == 2
    won = merged.lookup(_key())
    assert won["measured_us"] == 80.0 and won["plan"]["batch_tile"] == 4
    with pytest.raises(FileNotFoundError):
        main(["merge", str(out), str(tmp_path / "nope.json")])


def test_cli_prune_by_age_and_foreign(tmp_path, capsys):
    from repro_torch.plan_cache import main

    p = tmp_path / "c.json"
    _seed_cache(p, _key(), recorded="2001-01-01T00:00:00")  # ancient
    _seed_cache(p, _key(temporal=True))  # fresh
    foreign_key = _key().replace(host_fingerprint("cpu"), "other-host-torch0-cpu")
    _seed_cache(p, foreign_key)
    assert main(["prune", str(p), "--max-age-days", "30"]) == 0
    assert "removed 1" in capsys.readouterr().out
    assert main(["prune", str(p), "--foreign"]) == 0
    assert "removed 1" in capsys.readouterr().out
    assert set(PlanCache(str(p)).entries()) == {_key(temporal=True)}
    with pytest.raises(SystemExit):
        main(["prune", str(p)])


# ------------------------------------------------- files of both packages
def _jkey(temporal=False):
    return jworkload_key(JCFG, H, W, B, temporal, 1)


def test_jax_cache_file_loads_here_never_matches_and_merges(tmp_path):
    """A file the JAX package wrote loads in the port; its entries never
    match a lookup here (another fingerprint), and ``merge`` keeps them, so
    the JAX package still resolves from the merged file."""
    jpath, ppath, out = tmp_path / "jax.json", tmp_path / "port.json", tmp_path / "merged.json"
    jwinner = JBGPlan(cfg=JCFG, backend="fused", batch_tile=1)
    JPlanCache(str(jpath)).record(_jkey(), jwinner, measured_us=3.0)
    JPlanCache(str(jpath)).record_calibration(jhost_fingerprint(), {"step_overhead_s": 2e-6})
    assert jhost_fingerprint() != host_fingerprint("cpu") and _jkey() != _key()

    pc = PlanCache(str(jpath))
    assert set(pc.entries()) == {_jkey()}
    assert pc.lookup(_key()) is None
    assert _plan_for(n_frames=B, cache=pc).provenance == "model"

    PlanCache(str(ppath)).record(_key(), _plan(backend="fused_streamed", batch_tile=2), measured_us=5.0)
    merged = merge_caches(str(out), [str(jpath), str(ppath)])
    assert set(merged.entries()) == {_jkey(), _key()}
    assert merged.calibration(jhost_fingerprint()) is not None
    # each package resolves its own entry from the merged file
    mine = _plan_for(n_frames=B, cache=PlanCache(str(out)))
    assert mine.provenance == "cache" and mine.backend == "fused_streamed"
    theirs = jplan_for(JCFG, H, W, n_frames=B, sharded=False, cache=JPlanCache(str(out)))
    assert theirs.provenance == "cache" and theirs.plan_hash() == jwinner.plan_hash()
    # the port's prune --foreign drops the JAX entry from a shared file
    assert PlanCache(str(out)).prune(foreign=True) == [_jkey()]


def test_port_cache_file_loads_in_jax_never_matches_and_merges(tmp_path):
    """The reverse: a file the port wrote loads in the JAX package, never
    matches there, and the JAX package's ``merge`` keeps it for the port."""
    ppath, jpath, out = tmp_path / "port.json", tmp_path / "jax.json", tmp_path / "merged.json"
    winner = _plan(backend="fused", batch_tile=1, precision="bf16")
    PlanCache(str(ppath)).record(_key(), winner, measured_us=2.0)
    PlanCache(str(ppath)).record_calibration(host_fingerprint("cpu"), {"launch_overhead_s": 2e-5})

    jpc = JPlanCache(str(ppath))
    assert set(jpc.entries()) == {_key()} and jpc.lookup(_jkey()) is None
    assert jplan_for(JCFG, H, W, n_frames=B, sharded=False, cache=jpc).provenance == "model"

    JPlanCache(str(jpath)).record(_jkey(), JBGPlan(cfg=JCFG, backend="fused", batch_tile=2), measured_us=4.0)
    jmerge_caches(str(out), [str(ppath), str(jpath)])
    merged = PlanCache(str(out))
    assert set(merged.entries()) == {_key(), _jkey()}
    assert merged.calibration(host_fingerprint("cpu"))["constants"]["launch_overhead_s"] == 2e-5
    hit = _plan_for(n_frames=B, cache=merged, precision="auto")
    assert hit.provenance == "cache" and hit == winner
    # the same payload, the same hash, in both packages
    assert merged.lookup(_key())["plan_hash"] == JBGPlan.from_json(winner.to_json()).plan_hash()
