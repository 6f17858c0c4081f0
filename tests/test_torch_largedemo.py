"""The port's large-mesh demo (utils/largedemo.py) against the JAX package's,
and the bunny stand-in of utils/demo_scene.

On the CPU at a small size: the pickle path of both packages' scheme; the
scene `load_large_scene` builds from a tiny source OBJ (the blob at level 1,
subdivided once: 320 triangles) under LARGE_MODE, equal to the JAX
package's carried through `scene_from_numpy`, every array exactly and the
meta fields equal; its second call read from the pickle; and the
stand-in's face count and box, with the large tiers' shapes it gives at
levels 3 and 4 computed from the counts (no 1.27M-triangle build), and the
share of its triangles below the determinant epsilon at those levels.
`large_parity_and_time` times frames on a card only: its card case is in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu.ops import mesh_intersect as jmi
from relativitypathtracer_tpu.ops.pallas import mesh_large as jml
from relativitypathtracer_tpu.utils import largedemo as jld
from relativitypathtracer_tpu_torch.ops import mesh_intersect as pmi
from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as pml
from relativitypathtracer_tpu_torch.utils import demo_scene
from relativitypathtracer_tpu_torch.utils import largedemo as pld
from relativitypathtracer_tpu_torch.utils.subdiv import _parse_obj_vf, write_obj

LEVELS = 1


def _leaves(x, path="scene"):
    """(path, leaf) of every leaf of a Scene: tensors, numbers, None."""
    if isinstance(x, tuple):
        names = getattr(x, "_fields", range(len(x)))
        for name, v in zip(names, x):
            yield from _leaves(v, f"{path}.{name}")
    else:
        yield path, x


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A tiny source OBJ, and each package's load_large_scene of it (the
    port's on the CPU) with LARGE_MODE forced and SUPER_CULL_C at 0."""
    root = tmp_path_factory.mktemp("largedemo")
    verts, faces, _ = demo_scene.blob_mesh(1)
    src = str(root / "src" / "tiny.obj")
    (root / "src").mkdir()
    write_obj(src, verts, faces)
    saved = jld.SRC_OBJ, jml.SUPER_CULL_C, pml.SUPER_CULL_C
    jld.SRC_OBJ, jml.SUPER_CULL_C, pml.SUPER_CULL_C = src, 0, 0
    jmi.LARGE_MODE = pmi.LARGE_MODE = True
    try:
        want = jld.load_large_scene(workdir=str(root / "jax"), levels=LEVELS)
        got = pld.load_large_scene(str(root / "port"), LEVELS, "cpu", src)
    finally:
        jld.SRC_OBJ, jml.SUPER_CULL_C, pml.SUPER_CULL_C = saved
        jmi.LARGE_MODE = pmi.LARGE_MODE = None
    return src, str(root / "port"), want, got


@pytest.mark.parametrize("levels", [3, 4])
def test_xl_cache_path_matches_jax(tmp_path, monkeypatch, levels):
    """The same pickle path as the JAX package's for the same workdir,
    levels and source name: the default source (bunny.obj) and another."""
    assert pld.xl_cache_path(levels, str(tmp_path)) == jld.xl_cache_path(levels, str(tmp_path))
    assert pld.xl_cache_path(levels, str(tmp_path)).endswith(
        f"subdiv_bunny_{levels}/Scenes/scene.txt.host.pkl")
    other = str(tmp_path / "Models" / "stand.obj")
    monkeypatch.setattr(jld, "SRC_OBJ", other)
    assert pld.xl_cache_path(levels, str(tmp_path), other) == jld.xl_cache_path(levels,
                                                                                str(tmp_path))


def test_load_large_scene_matches_jax(built):
    """Every array of the port's scene equal to the JAX package's carried
    through scene_from_numpy (dtype and values), the large tier engaged on
    both sides, and the meta fields the two share equal."""
    src, workdir, (js, jm), (ps, pm) = built
    assert js.mesh_static[0].gen_rec is not None and ps.mesh_static[0].gen_rec is not None
    assert pm.num_tris == len(_parse_obj_vf(src)[1]) * 4 ** LEVELS == 320
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    got, want = dict(_leaves(ps)), dict(_leaves(carried))
    assert got.keys() == want.keys()
    n = 0
    for path, g in got.items():
        w = want[path]
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), path
            n += 1
        else:
            assert g == w, path
    assert n > 30
    shared = ({f.name for f in dataclasses.fields(pm)}
              & {f.name for f in dataclasses.fields(jm)})
    assert {"num_tris", "mesh_tri_ranges", "mesh_perms", "num_nodes"} <= shared
    for field in shared:
        assert getattr(pm, field) == getattr(jm, field), field


def test_second_load_reads_the_pickle(built, monkeypatch):
    """The second call parses nothing (load_scene_file raises if called)
    and builds the same scene from the pickled HostScene."""
    src, workdir, _, (ps, _) = built

    def no_parse(*a, **k):
        raise AssertionError("load_scene_file called: the pickle was not read")

    monkeypatch.setattr(pld, "load_scene_file", no_parse)
    monkeypatch.setattr(pmi, "LARGE_MODE", True)
    assert pld.xl_cache_path(LEVELS, workdir, src).endswith(".host.pkl")
    again, _ = pld.load_large_scene(workdir, LEVELS, "cpu", src)
    a, b = dict(_leaves(again)), dict(_leaves(ps))
    assert a.keys() == b.keys()
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, b[path]), path


def test_large_parity_and_time_needs_a_card():
    """No frame is timed on the host in the card's place."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        pld.large_parity_and_time(64, 48, device="cpu")


def test_main_names_a_missing_source(tmp_path, capsys):
    assert pld.main(["--src", str(tmp_path / "absent.obj")]) == 1
    assert "no source OBJ" in capsys.readouterr().err


def test_bunny_stand_in_has_bunny_counts_and_box(tmp_path):
    """4,968 faces inside bunny's box, each vertex used; 4,968 x 4^L
    triangles give the JAX package's large tiers: at L = 3 317,952
    triangles, 9,936 chunks, 311 supers of 32 (large_mesh); at L = 4
    1,271,808, 39,744 chunks, above SUPER_CULL_C, so 311 supers of 128 with
    a ragged last super of 64 chunks and bit rows of 1,244 words
    (large_mesh_xl, the shapes of tests/test_tpu_lowering.py)."""
    path = demo_scene.write_bunny_stand_in(str(tmp_path / "Models" / "bunny_stand_in.obj"))
    verts, faces = _parse_obj_vf(path)
    v = np.asarray(verts)
    lo, hi = np.asarray(demo_scene.BUNNY_BOX)
    assert len(faces) == demo_scene.BUNNY_FACES == 4968
    assert np.all(v >= lo - 1e-7) and np.all(v <= hi + 1e-7)
    np.testing.assert_allclose(v.min(axis=0), lo, atol=1e-7)
    np.testing.assert_allclose(v.max(axis=0), hi, atol=1e-7)
    assert sorted({i for f in faces for i in f}) == list(range(len(verts)))
    shapes = {}
    for levels in (3, 4):
        T = len(faces) * 4 ** levels
        C = pmi.padded_tri_count(T) // 32
        S = pml._super_s(C)
        n_super = -(-C // S)
        shapes[levels] = (T, C, S, n_super, C - (n_super - 1) * S, n_super * S // 32)
        assert pml._super_s(C) == jml._super_s(C)
    assert shapes[3] == (317_952, 9_936, 32, 311, 16, 311)
    assert shapes[4] == (1_271_808, 39_744, 128, 311, 64, 1_244)
    assert shapes[3][1] <= pml.SUPER_CULL_C < shapes[4][1]


def test_xl_triangles_fall_below_the_determinant_epsilon(tmp_path):
    """Why the XL frame shows the mesh with holes and no shadow on it: the
    Moller-Trumbore test rejects |det| < 1e-7 (object space) in both
    packages and in the C++ oracle, and |det| = 2 x area x |cos| for a unit
    direction. Midpoint subdivision quarters each area, so at levels 4
    about 73% of the stand-in's triangles have twice their area below the
    epsilon and fail at any incidence; at levels 3 none does."""
    import pathlib
    import re

    from relativitypathtracer_tpu.ops.pallas import mesh_kernels as jmk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk

    oracle = (pathlib.Path(__file__).resolve().parents[1] / "native"
              / "cpu_reference.cpp").read_text()
    eps = float(re.search(r"kEps = ([0-9.e-]+)f;", oracle).group(1))
    assert pmk.EPSILON == jmk.EPSILON == eps == 1e-7
    verts, faces = _parse_obj_vf(demo_scene.write_bunny_stand_in(
        str(tmp_path / "bunny_stand_in.obj")))
    v, f = np.asarray(verts), np.asarray(faces)
    twice_area = np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                                axis=1)
    below = {levels: float(np.mean(twice_area / 4 ** levels < eps)) for levels in (3, 4)}
    assert below[3] == 0.0 and 0.7 < below[4] < 0.75, below
