"""Guards of the port: it imports without JAX, chip_smoke.py has no CPU
fallback, and the CLI renders through the entry points a user calls."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_without_jax():
    code = ("import sys, relativitypathtracer_tpu_torch, relativitypathtracer_tpu_torch.cli, "
            "relativitypathtracer_tpu_torch.utils.demo_scene, "
            "relativitypathtracer_tpu_torch.utils.largedemo, "
            "relativitypathtracer_tpu_torch.parallel.tiles, relativitypathtracer_tpu_torch.utils.aot; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('relativitypathtracer_tpu.') or m == 'relativitypathtracer_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_import():
    for path in (REPO / "relativitypathtracer_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or "relativitypathtracer_tpu." in s and s.startswith(("import", "from"))
                        or s.startswith("from relativitypathtracer_tpu import")), (path, line)


def test_port_sources_import_no_pil():
    """The port decodes every texture format itself: no module of it, nor
    chip_smoke.py or the port's interactive bench, imports PIL."""
    paths = [*(REPO / "relativitypathtracer_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "tools" / "interact_bench_torch.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import PIL", "from PIL")), (path, line)


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The kernels of one instances replay, as its graph names them (mangled, the
# form utils/frame_graph.kernel_names reads on the card), and two of PyTorch's.
_INSTANCES_NODES = {
    "rpt_shadow_chain": "_ZN48_GLOBAL__N__7732686f_15_shadow_chain_cu_438d4b41"
                        "19shadow_chain_kernelEPKfi",
    "rpt_footprint_sample/small": "_ZN51_GLOBAL__N__29919299_18_texture_kernels_cu_66391ad3"
                                  "16footprint_kernelILb1ELb1EEEvPK4i",
    "rpt_analytic_nearest": "_ZN52_GLOBAL__N__813ff364_19_analytic_kernels_cu_490d37a2"
                            "23analytic_nearest_kernelEPKfiiS1",
    "rpt_cone_table": "_ZN46_GLOBAL__N__4c289e6d_13_live_lists_cu_19a6e341"
                      "17cone_table_kernelILb0EEEv",
    "rpt_live_cull": "_ZN46_GLOBAL__N__4c289e6d_13_live_lists_cu_19a6e341"
                     "16live_cull_kernelENS_4CullE",
    "rpt_bucket_order": "_ZN46_GLOBAL__N__4c289e6d_13_live_lists_cu_19a6e341"
                        "19bucket_order_kernelEPKf",
    "rpt_batched_shared_walk": "_ZN48_GLOBAL__N__5d1c0e2a_13_mesh_batch_cu_7e21b9c4"
                               "26batched_shared_walk_kernelEv",
    "rpt_batched_general_walk": "_ZN48_GLOBAL__N__5d1c0e2a_13_mesh_batch_cu_7e21b9c4"
                                "27batched_general_walk_kernelEv",
}
_TORCH_NODES = ["_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13BinaryFunctor",
                "_ZN2at6native40_GLOBAL__N__0f1a8107_8_Shape_cu_49f7391c30CatArrayBatchedCopy"]
_PER_FRAME = {"rpt_shadow_chain": 1, "rpt_footprint_sample/small": 1, "rpt_analytic_nearest": 1,
              "rpt_cone_table": 2, "rpt_live_cull": 2, "rpt_bucket_order": 2,
              "rpt_batched_shared_walk": 1, "rpt_batched_general_walk": 1}


def _nodes(counts):
    return _TORCH_NODES + [_INSTANCES_NODES[k] for k, n in counts.items() for _ in range(n)]


@pytest.mark.parametrize("case", ["complete", "lacks_K3", "K3_twice", "no_K3_counted",
                                  "unmapped_port_kernel"])
def test_replay_verdict_reads_the_graph_nodes(case):
    """chip_smoke.py's traced-replay check on the kernel names of a replayed
    graph: a graph holding each counted kernel as often as the replay counted
    it passes; one lacking K3, holding it twice, a replay that counted no K3,
    and a port kernel no launch key names fail."""
    smoke = _chip_smoke()
    nodes, added = _nodes(_PER_FRAME), dict(_PER_FRAME)
    if case == "lacks_K3":
        nodes.remove(_INSTANCES_NODES["rpt_analytic_nearest"])
    elif case == "K3_twice":
        nodes.append(_INSTANCES_NODES["rpt_analytic_nearest"])
    elif case == "no_K3_counted":
        del added["rpt_analytic_nearest"]
    elif case == "unmapped_port_kernel":
        nodes.append("_ZN52_GLOBAL__N__813ff364_19_analytic_kernels_cu_490d37a212other_kernelEv")
    if case == "complete":
        got = smoke.replay_verdict(nodes, added, _PER_FRAME, "instances")
        assert got == {k.split("/")[0]: n for k, n in _PER_FRAME.items()}
        return
    with pytest.raises(smoke.CheckFailed) as err:
        smoke.replay_verdict(nodes, added, _PER_FRAME, "instances")
    assert "instances" in str(err.value)


@pytest.mark.parametrize("kind", ["blob", "instances"])
def test_cli_renders_the_fixture_on_cpu(tmp_path, kind):
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    scene = write_demo_scene(str(tmp_path), 2, kind)
    out = tmp_path / "frame.png"
    proc = subprocess.run(
        [sys.executable, "-m", "relativitypathtracer_tpu_torch.cli", "--scene", scene,
         "--size", "64x48", "--frames", "2", "--velocity", "0.5,0,0", "--out", str(out),
         "--metrics", "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["frames"] == 2 and metrics["device"] == "cpu"
    assert metrics["rays_last_frame"] > 64 * 48
    assert out.stat().st_size > 0


def test_cli_renders_msaa_and_interval_on_cpu(tmp_path):
    """--msaa 2 counts four primary rays per pixel; --interval 0 turns light
    propagation and with it the shadow rays off."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    scene = write_demo_scene(str(tmp_path), 1, "textured")
    runs = {}
    for flags in (["--msaa", "2"], ["--interval", "0"]):
        proc = subprocess.run(
            [sys.executable, "-m", "relativitypathtracer_tpu_torch.cli", "--scene", scene,
             "--size", "32x32", "--metrics", "--device", "cpu", *flags],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[flags[0]] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert runs["--msaa"]["rays_last_frame"] > 4 * 32 * 32
    assert runs["--interval"]["rays_last_frame"] == 32 * 32


def test_wrappers_never_fall_back_off_the_cpu():
    """A wrapper takes its plain twin only for CPU tensors: any other device
    either launches the CUDA kernel or raises (here, meta tensors raise
    before any build or launch)."""
    from relativitypathtracer_tpu_torch.ops.kernels import (
        analytic_kernels, mesh_batch, mesh_kernels, mesh_large, shadow_chain, texture_kernel)

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    calls = [
        lambda: mesh_kernels.shared_walk(m(1, 4, dtype=i32), m(1, 4), m(1, dtype=i32), m(9),
                                         m(128, 10), m(128, 15), m(3, 1024)),
        lambda: mesh_kernels.general_walk(m(1, 4, dtype=i32), m(1, 4), m(1, dtype=i32), m(6),
                                          m(128, 20), m(10, 1024), m(2, 1024)),
        lambda: analytic_kernels.analytic_nearest_shared(m(1, 32), m(4, 64), 1, 0),
        lambda: shadow_chain.shadow_chain(m(40, 2), m(1, 36), m(4, 64), m(64), m(3, 64),
                                          m(64, dtype=i32), -1),
        lambda: analytic_kernels.analytic_min_t_general(m(2, 32), m(4, 64), m(4, 64), 1, 1,
                                                        m(64)),
        lambda: texture_kernel.footprint_fetch(m(512, 8, dtype=i32), m(2, 11, dtype=i32),
                                               m(64, dtype=i32), m(2, 64)),
        lambda: mesh_batch.batched_shared_walk(
            m(1, 8, dtype=i32), m(1, 8), m(1, dtype=i32), m(8, dtype=i32), m(2, 9),
            m(2, mesh_batch.MAT_COLS), m(256, 10), m(256, 15), m(4, 1024)),
        lambda: mesh_batch.batched_general_walk(
            m(1, 8, dtype=i32), m(1, 8), m(1, dtype=i32), m(8, dtype=i32), m(2, 6),
            m(2, mesh_batch.MAT_COLS), m(256, 20), m(4, 1024), m(4, 1024), m(1024)),
        lambda: mesh_large.large_shared_walk(
            m(1, 1, dtype=i32), m(1, 1), m(1, dtype=i32), m(1, 1, dtype=i32), m(9),
            m(256, 10), m(256, 15), m(3, 1024), 32, 8, 256),
        lambda: mesh_large.large_general_walk(
            m(1, 1, dtype=i32), m(1, 1), m(1, dtype=i32), m(1, 1, dtype=i32), m(6),
            m(256, 20), m(10, 1024), m(2, 1024), 32, 8, 256),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()


@pytest.mark.parametrize("walk", ["large_shared_walk", "large_general_walk"])
def test_large_walks_refuse_partial_bit_words(walk):
    """K11 and K12 walk a superchunk's bit words whole, so their wrappers
    refuse an S that is not a multiple of 32 before any build or launch."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    rest = ((m(9), m(256, 10), m(256, 15), m(3, 1024)) if walk == "large_shared_walk"
            else (m(6), m(256, 20), m(10, 1024), m(2, 1024)))
    with pytest.raises(ValueError, match="multiple of 32"):
        getattr(mesh_large, walk)(m(1, 1, dtype=i32), m(1, 1), m(1, dtype=i32),
                                  m(1, 1, dtype=i32), *rest, 48, 8, 256)


def test_launch_refuses_tensors_on_two_devices():
    """A launch runs on the device that holds its tensors: tensors on two
    devices raise before any build or launch."""
    from relativitypathtracer_tpu_torch.ops.kernels import _build

    with pytest.raises(ValueError, match="more than one device"):
        _build.launch("rpt_bucket_order", torch.empty(4, 4), torch.empty(4, 4, device="meta"),
                      4, 4, None, None, None)
    assert not _build.LAUNCHES["rpt_bucket_order"]
