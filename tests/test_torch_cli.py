"""The port's CLI against the JAX package's CLI contract, on the CPU: the
--metrics keys and their meaning, --paused, --gif, --asset-root and
--profile, on the blob fixture at a small size."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from relativitypathtracer_tpu_torch import cli
from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    return write_demo_scene(str(tmp_path_factory.mktemp("cli_blob")), 1, "blob")


def _port(capsys, *flags):
    assert cli.main([*map(str, flags), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]) if "--metrics" in flags \
        else None


def test_metrics_keys_extend_the_jax_clis(blob, tmp_path, capsys):
    """The same flags through both CLIs: the port prints every key the JAX
    CLI prints, with the same value where it is not a time, and the same
    rule for the rate (primary rays over p50); its shadow-inclusive rate
    and ray count sit under keys of their own."""
    flags = ["--scene", blob, "--size", "32x24", "--frames", "2", "--msaa", "2", "--metrics"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"))
    proc = subprocess.run([sys.executable, "-m", "relativitypathtracer_tpu.cli", *flags,
                           "--platform", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = _port(capsys, *flags)
    assert set(want) <= set(got)
    for key in ("width", "height", "frames", "primary_rays", "platform"):
        assert got[key] == want[key], key
    assert got["primary_rays"] == 4 * 32 * 24 and got["platform"] == "cpu"
    for m in (got, want):
        assert m["mrays_per_sec_p50"] == pytest.approx(m["primary_rays"] / (m["p50_ms"] * 1e3))
        assert m["best_ms"] <= m["p50_ms"] and m["first_ms"] > 0
    assert got["rays_last_frame"] > got["primary_rays"]
    assert got["mrays_per_sec_p50_with_shadow"] == pytest.approx(
        got["rays_last_frame"] / (got["p50_ms"] * 1e3))


def test_paused_renders_equal_frames(blob, tmp_path, capsys):
    """--paused keeps the scene time: every frame of the GIF is the first
    (the fixture moves at 0.5c, so advancing time changes the frame)."""
    from PIL import Image, ImageSequence

    frames = {}
    for paused in (True, False):
        out = tmp_path / f"paused{paused}.png"
        first = tmp_path / f"first{paused}.png"
        common = ["--scene", blob, "--size", "32x24", "--velocity", "0.5,0,0", "--dt", "0.5"]
        _port(capsys, *common, "--frames", "1", "--out", first)
        _port(capsys, *common, "--frames", "3", "--out", out, *(["--paused"] if paused else []))
        frames[paused] = (np.asarray(Image.open(first)), np.asarray(Image.open(out)))
    assert np.array_equal(*frames[True])
    assert not np.array_equal(*frames[False])
    gif = tmp_path / "paused.gif"
    _port(capsys, "--scene", blob, "--size", "32x24", "--frames", "2", "--paused", "--gif", gif)
    shots = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(gif))]
    assert all(np.array_equal(s, shots[0]) for s in shots)


def test_gif_writes_every_frame(blob, tmp_path, capsys):
    """--gif writes one GIF frame per rendered frame (the scene moves, so
    they differ), each lasting --dt."""
    from PIL import Image, ImageSequence

    gif = tmp_path / "anim.gif"
    _port(capsys, "--scene", blob, "--size", "32x24", "--frames", "3", "--velocity", "0.5,0,0",
          "--dt", "0.5", "--gif", gif)
    im = Image.open(gif)
    assert im.n_frames == 3 and im.info["duration"] == 500
    shots = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    assert not np.array_equal(shots[0], shots[-1])


def test_asset_root_loads_a_scene_away_from_its_assets(blob, tmp_path, capsys):
    """A scene file moved away from its Models/ loads with --asset-root
    naming the directory that holds them, and fails cleanly without it."""
    moved = tmp_path / "elsewhere" / "scene.txt"
    moved.parent.mkdir()
    shutil.copy(blob, moved)
    root = pathlib.Path(blob).parents[1]
    with_root = _port(capsys, "--scene", moved, "--asset-root", root, "--size", "32x24",
                      "--metrics")
    in_place = _port(capsys, "--scene", blob, "--size", "32x24", "--metrics")
    assert with_root["rays_last_frame"] == in_place["rays_last_frame"] > 32 * 24
    assert cli.main(["--scene", str(moved), "--size", "32x24", "--device", "cpu"]) == 1
    assert "Error" in capsys.readouterr().err


def test_profile_writes_a_trace(blob, tmp_path, capsys):
    """--profile DIR writes a torch.profiler chrome trace of the frames."""
    _port(capsys, "--scene", blob, "--size", "32x24", "--frames", "2", "--profile",
          tmp_path / "prof")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 0
