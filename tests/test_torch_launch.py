"""The port's launcher against the JAX launcher: every option the two
parsers share has the same default, type and choices, so one command line
serves the same traffic in both packages."""
import argparse
import sys

import pytest

import repro.launch.serve as JS
import repro_torch.launch.serve as TS


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


def test_lm_mode_ckpt_dir_raises_until_ported():
    with pytest.raises(NotImplementedError, match="A11b"):
        TS.main(["--arch", "yi-6b", "--smoke", "--ckpt-dir", "ckpt", "--device", "cpu"])
    with pytest.raises(SystemExit):  # one mode at a time
        TS.main(["--arch", "yi-6b", "--frames", "2", "--device", "cpu"])
