"""The port's scene blob and oracle parity, and its timing helpers.

- `utils/scene_blob.scene_blob` equals the JAX package's blob byte for byte
  on the fixtures blob, textured, cubes and instances (level 3), at rest,
  with the camera at 0.5c and at bench.py's boosted state (`rulers_boosted`:
  velocity (0.3, 0.1, -0.2), position (2.5, 0, 0, 0)), at interval -1 and 0,
  for equal scene arrays: the JAX package's build
  carried over with `scene_from_numpy` (the port's own build has rotation
  matrices within 1e-6 of the JAX package's, not to the bit:
  test_torch_scene.py), so both serialize the same arrays with host
  float32 numpy boosts.
- The port's CPU frame against the C++ oracle (native/cpu_reference.cpp,
  compiled into build/oracle/ by `utils/parity.oracle_path`) at 128x96 on
  those fixtures and states: the parity rule, at most 0.2% of pixels off by
  more than 1e-3 (`parity.MAX_FRAC_BAD`), and a mean difference under
  1e-4; at interval -1 and at interval 0 (no light propagation, no shadow
  ray), where the counts say no shadow ray was cast.
- `utils/timing.percentile` equal to the JAX package's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import build_both, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.utils import parity

KINDS = ("blob", "textured", "cubes", "instances")
STATES = {
    "rest": ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)),
    "0.5c": ((0.5, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)),
    "bench_boosted": ((0.3, 0.1, -0.2), (2.5, 0.0, 0.0, 0.0)),  # bench.py's rulers_boosted
}
W, H = 128, 96


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    return {kind: build_both(write_fixture(tmp_path_factory, 3, kind)) for kind in KINDS}


def _port_state(state):
    return prender.FrameState(torch.tensor(state[0]), torch.tensor(state[1]))


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", KINDS)
def test_scene_blob_bytes_equal_jax(fixtures, kind, state):
    from relativitypathtracer_tpu.render import FrameState as JaxFrameState
    from relativitypathtracer_tpu.utils.scene_blob import scene_blob as jax_blob

    from relativitypathtracer_tpu_torch.utils.scene_blob import MAGIC, MAGIC_VERSION, scene_blob

    (js, jm), (_, pm) = fixtures[kind]
    ps = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    v, p = STATES[state]
    want = jax_blob(js, jm, JaxFrameState(jnp.asarray(v, jnp.float32), jnp.asarray(p, jnp.float32)),
                    W, H)
    got = scene_blob(ps, pm, _port_state(STATES[state]), W, H)
    assert got[:4] == MAGIC and int.from_bytes(got[4:8], "little") == MAGIC_VERSION
    assert got == want


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_frame_matches_oracle(fixtures, kind, state, tmp_path):
    _, (ps, pm) = fixtures[kind]
    st = _port_state(STATES[state])
    ref, stats = parity.run_oracle(ps, pm, st, W, H, str(tmp_path), f"{kind}_{state}")
    assert (stats["width"], stats["height"]) == (W, H) and stats["threads"] >= 1
    ours = prender.render_frame(ps, pm, st, W, H, device="cpu")
    res = parity.compare(ours.numpy(), ref)
    assert res["ok"] and res["frac_bad"] <= parity.MAX_FRAC_BAD, res
    assert res["mean_diff"] < 1e-4, res


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", KINDS)
def test_scene_blob_bytes_equal_jax_at_interval0(fixtures, kind, state):
    from relativitypathtracer_tpu.render import FrameState as JaxFrameState
    from relativitypathtracer_tpu.utils.scene_blob import scene_blob as jax_blob

    from relativitypathtracer_tpu_torch.utils.scene_blob import scene_blob

    (js, jm), (_, pm) = fixtures[kind]
    ps = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    v, p = STATES[state]
    want = jax_blob(js, jm, JaxFrameState(jnp.asarray(v, jnp.float32), jnp.asarray(p, jnp.float32)),
                    W, H, 0)
    got = scene_blob(ps, pm, _port_state(STATES[state]), W, H, 0)
    assert got == want and got != scene_blob(ps, pm, _port_state(STATES[state]), W, H, -1)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_frame_matches_oracle_at_interval0(fixtures, kind, state, tmp_path):
    _, (ps, pm) = fixtures[kind]
    st = _port_state(STATES[state])
    ref, _ = parity.run_oracle(ps, pm, st, W, H, str(tmp_path), f"{kind}_{state}_i0", interval=0)
    render = prender.build_render_fn(pm, W, H, 0, with_aux=True, device="cpu")
    ours, aux = render(ps, st)
    res = parity.compare(ours.numpy(), ref)
    assert res["ok"] and res["frac_bad"] <= parity.MAX_FRAC_BAD, res
    assert res["mean_diff"] < 1e-4, res
    assert int(aux["hits"]) > 0 and int(aux["shadow_rays"]) == 0


def test_oracle_builds_from_the_repository_source():
    """The binary is compiled from native/cpu_reference.cpp into build/oracle/
    (never the tracked native/cpu_reference), once per process."""
    path = parity.oracle_path()
    assert os.path.dirname(path) == str(parity.ORACLE_DIR) and os.access(path, os.X_OK)
    assert parity.oracle_path() == path


def test_fullres_parity_takes_a_fixture_kind(tmp_path):
    res = parity.fullres_parity("cubes", 96, 64, workdir=str(tmp_path), device="cpu")
    assert set(res) == {"scene", "frac_bad", "mean_diff", "ok"}
    assert res["scene"] == "cubes" and res["ok"], res
    with pytest.raises(FileNotFoundError):
        parity.fullres_parity("no_such_scene", 32, 32, workdir=str(tmp_path), device="cpu")


def test_parity_main_writes_its_artifact(tmp_path, capsys):
    out = tmp_path / "parity.json"
    rc = parity.main(["--device", "cpu", "--out", str(out), "cubes"])
    assert rc == 0
    art = json.loads(out.read_text())
    assert art["ok"] and art["platform"] == "cpu" and art["resolution"] == "1024x768"
    assert [s["scene"] for s in art["scenes"]] == ["cubes"]
    assert json.loads(capsys.readouterr().out.splitlines()[0])["scene"] == "cubes"


@pytest.mark.parametrize("q", [0.0, 12.5, 50.0, 95.0, 99.0, 100.0])
def test_percentile_matches_jax(q):
    from relativitypathtracer_tpu.utils.timing import percentile as jax_percentile

    from relativitypathtracer_tpu_torch.utils.timing import percentile

    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 60):
        vals = sorted(rng.uniform(1.0, 30.0, n).tolist())
        assert percentile(vals, q) == jax_percentile(vals, q)


def test_cuda_frame_timer_refuses_the_cpu(monkeypatch):
    """No CUDA device: the timer raises instead of timing on the host."""
    from relativitypathtracer_tpu_torch.utils import timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.cuda_frame_times_ms(lambda s, st: None, None, None)
