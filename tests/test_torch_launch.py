"""The port's launchers against the JAX launchers: every option the two
parsers share has the same default, type and choices, so one command line
serves the same traffic (``launch/serve.py``) and trains on the same data
(``launch/train.py``) in both packages."""
import argparse
import os
import sys

import numpy as np
import pytest

import repro.launch.serve as JS
import repro.launch.train as JL
import repro_torch.launch.serve as TS
import repro_torch.launch.train as TL
import repro_torch.models as TM
import repro_torch.train as TT


class _Captured(Exception):
    pass


def _parser_of(main, monkeypatch, argv=None):
    """The ``ArgumentParser`` ``main`` builds, caught at its ``parse_args``
    (the JAX parser is built inside ``main()`` and has no handle of its
    own): run ``main`` with the program name alone on ``sys.argv``, record
    the parser and stop it there."""
    seen = []

    def record(self, *args, **kwargs):
        seen.append(self)
        raise _Captured

    monkeypatch.setattr(sys, "argv", ["serve"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    with pytest.raises(_Captured):
        main() if argv is None else main(argv)
    assert len(seen) == 1
    return {opt: a for a in seen[0]._actions for opt in a.option_strings}


def test_shared_options_have_the_jax_defaults(monkeypatch):
    jax_opts = _parser_of(JS.main, monkeypatch)
    port_opts = _parser_of(TS.main, monkeypatch, argv=[])
    shared = sorted(set(jax_opts) & set(port_opts) - {"-h", "--help"})
    # the serving options of both launchers, the LM mode's included; the
    # port's --config / --device are its own
    assert set(shared) >= {
        "--frames", "--video", "--video-frames", "--micro-batch", "--frame-hw", "--stream-input",
        "--alpha", "--fps", "--deadline-ms", "--batch-window-ms", "--workers", "--worker-backend",
        "--arch", "--smoke", "--ckpt-dir", "--slots", "--max-len", "--requests", "--max-tokens",
    }, shared
    for opt in shared:
        j, t = jax_opts[opt], port_opts[opt]
        assert (t.dest, t.default, t.type, t.choices, t.nargs, t.const) == (
            j.dest, j.default, j.type, j.choices, j.nargs, j.const
        ), opt
    assert port_opts["--video-frames"].default == 24
    assert port_opts["--micro-batch"].default == 16
    assert (port_opts["--requests"].default, port_opts["--max-tokens"].default) == (8, 16)


def test_serve_frames_default_micro_batch_is_the_cli_default(monkeypatch):
    import inspect

    port_opts = _parser_of(TS.main, monkeypatch, argv=[])
    default = inspect.signature(TS.serve_frames).parameters["micro_batch"].default
    assert default == port_opts["--micro-batch"].default


def test_cli_needs_a_positive_mode_count():
    with pytest.raises(SystemExit):
        TS.main(["--frames", "0", "--device", "cpu"])
    with pytest.raises(SystemExit):
        TS.main(["--frames", "2", "--workers", "2", "--device", "cpu"])


def test_lm_mode_serves_on_the_cpu(capsys):
    TS.main(["--arch", "yi-6b", "--smoke", "--requests", "3", "--max-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


def test_lm_warmup_leaves_the_served_tokens_as_they_are():
    kw = dict(smoke=True, requests=5, max_tokens=4, device="cpu")
    cold, warm = TS.serve_lm("yi-6b", **kw), TS.serve_lm("yi-6b", warmup=2, **kw)
    assert warm["generated"] == cold["generated"] and warm["tokens"] == 20
    assert len(warm["prefill_ms"]) == 5 and warm["steps"] == cold["steps"]


def test_lm_mode_ckpt_dir_raises_until_ported(tmp_path):
    """``--ckpt-dir`` restores the latest checkpoint (ported with the
    training slice); a directory without one raises, as in JAX."""
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        TS.main(["--arch", "yi-6b", "--smoke", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit):  # one mode at a time
        TS.main(["--arch", "yi-6b", "--frames", "2", "--device", "cpu"])


def test_lm_mode_serves_a_checkpoint(tmp_path, capsys):
    TL.main(["--arch", "yi-6b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
             "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    TS.main(["--arch", "yi-6b", "--smoke", "--requests", "2", "--max-tokens", "3",
             "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "restored step 2: 2 requests, 6 tokens" in capsys.readouterr().out


# ------------------------------------------------------------ the train launcher
@pytest.fixture
def keep_signal_handlers():
    """The Trainers install SIGTERM/SIGINT handlers; put the runner's back."""
    import signal

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    yield
    for sig, h in saved.items():
        signal.signal(sig, h)


def test_train_launcher_options_are_the_jax_ones(monkeypatch):
    jax_opts = _parser_of(JL.main, monkeypatch)
    port_opts = _parser_of(TL.main, monkeypatch, argv=[])
    assert set(jax_opts) == set(port_opts) - {"--device"}
    for opt in jax_opts:
        if opt in ("-h", "--help"):
            continue
        j, t = jax_opts[opt], port_opts[opt]
        assert (t.dest, t.default, t.type, t.choices, t.nargs, t.const, t.required) == (
            j.dest, j.default, j.type, j.choices, j.nargs, j.const, j.required
        ), opt
    assert (port_opts["--steps"].default, port_opts["--batch"].default, port_opts["--seq"].default,
            port_opts["--lr"].default, port_opts["--ckpt-dir"].default, port_opts["--ckpt-every"].default) == (
        200, 8, 256, 3e-4, "checkpoints", 100)
    import inspect

    sig = inspect.signature(TL.train_lm).parameters
    for name in ("steps", "batch", "seq", "lr", "ckpt_dir", "ckpt_every"):
        assert sig[name].default == port_opts["--" + name.replace("_", "-")].default, name


@pytest.mark.parametrize("flag", [["--mesh", "1x1"], ["--mesh", "4x2"]])
def test_train_launcher_mesh_and_distributed_raise(flag, tmp_path, keep_signal_handlers):
    """``--mesh`` in a world of one (no ``--distributed``): a mesh of one
    device trains on a world-1 group made in-process (destroyed after),
    laid out as DTensors; a larger mesh raises naming the world size it
    needs and writes nothing. The multi-rank launcher is in
    ``test_torch_lm_sharding.py``, ``--distributed`` under torchrun's
    environment in ``chip_smoke.py``'s ``lm_mesh_slice``."""
    import torch.distributed as dist

    argv = ["--arch", "yi-6b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
            str(tmp_path), "--device", "cpu", *flag]
    if flag[1] == "4x2":
        with pytest.raises(ValueError, match="needs a process group of 8 ranks"):
            TL.main(argv)
        assert os.listdir(tmp_path) == [] and not dist.is_initialized()
        return
    st = TL.main(argv)
    assert (st["mesh"], st["world_size"], st["last_step"]) == ([1, 1], 1, 2) and not dist.is_initialized()
    assert np.isfinite(st["loss"]).all()
    assert all(type(t).__name__ == "DTensor" for t in TM.tree_leaves(st["trainer"].params))
    assert os.path.isdir(os.path.join(tmp_path, "step_00000002"))


def test_train_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys, keep_signal_handlers):
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    st = TL.main(argv + ["--steps", "3"])
    assert (st["state"], st["first_step"], st["last_step"]) == ("initialized", 0, 3)
    assert len(st["loss"]) == 3 and np.isfinite(st["loss"]).all() and st["tokens_per_s"] > 0
    assert st["final"]["loss"] == st["loss"][-1] and st["device"] == "cpu"
    # the JAX launcher's schedule: warmup min(100, steps // 10 + 1), decay over steps
    assert st["trainer"].opt_cfg == TT.OptConfig(lr=3e-4, warmup_steps=1, decay_steps=3)
    st = TL.main(argv + ["--steps", "5"])
    assert (st["state"], st["first_step"], st["last_step"]) == ("resumed", 3, 5)
    out = capsys.readouterr().out
    assert "initialized at step 0" in out and "resumed at step 3" in out and "done at step 5" in out
