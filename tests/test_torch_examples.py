"""The port's examples (``python -m repro_torch.examples.<name>``), each
run through its ``main`` on the CPU at a tiny size: every act runs, the
checks each example prints hold, and importing a module runs nothing."""
import importlib

import pytest

EXAMPLES = ("quickstart", "denoise_stream", "denoise_video", "denoise_fleet")


@pytest.mark.parametrize("name", EXAMPLES)
def test_importing_an_example_runs_nothing(name, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert callable(mod.main)
    assert capsys.readouterr().out == ""


def test_quickstart(capsys):
    from repro_torch.examples import quickstart

    res = quickstart.main(["--device", "cpu", "--height", "48", "--width", "64", "--radii", "4,8",
                           "--reps", "1"])
    q = res["quality"]
    noisy = q["noisy input"][0]
    assert all(m > noisy for name, (m, _) in q.items() if name != "noisy input")
    # the fused kernel's plain version and the plan give the reference's image
    bg = q["BG (this paper)"]
    assert q["BG fused kernel (B1)"] == bg
    assert sorted(res["sweep"]) == [4, 8] and res["device"] == "cpu"
    assert "window-radius sweep" in capsys.readouterr().out


def test_denoise_stream():
    from repro_torch.examples import denoise_stream

    res = denoise_stream.main(["--device", "cpu", "--height", "40", "--width", "56", "--frames", "3"])
    assert len(res["max_diff_vs_reference"]) == 3
    assert max(res["max_diff_vs_reference"]) <= 1.0  # one quantization LSB at most
    assert res["looped_equal_batched"]


def test_denoise_video():
    from repro_torch.examples import denoise_video

    res = denoise_video.main(["--device", "cpu", "--height", "32", "--width", "48", "--frames", "3",
                              "--streams", "2"])
    assert res["alpha0_equal"]
    assert res["served"] == 6 and res["failed"] == 0
    assert set(res["static_psnr"]) == {0.0, 0.3, 0.6, 0.8}


def test_denoise_fleet():
    from repro_torch.examples import denoise_fleet

    res = denoise_fleet.main(["--device", "cpu", "--height", "32", "--width", "48", "--frames", "4",
                              "--workers", "3", "--streams", "6"])
    assert res["workers_alive"] == 2 and res["failed"] == 0
    assert res["completed"] == res["frames"]
    # every stream of the killed worker moved to a survivor
    assert sorted(s for s, _ in res["moved"]) == res["victim_streams"]
    assert all(w != res["victim"] for _, w in res["moved"])
