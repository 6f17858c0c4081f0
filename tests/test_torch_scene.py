"""The port's host scene layer against the JAX package's, on the fixture.

The same scene file goes through each package's load_scene_file and
build_scene; every Scene array must be equal (exactly) and the SceneMeta
fields equal. scene_from_numpy carries the JAX package's arrays over.
"""

import numpy as np
import pytest
import torch
from torch_port_fixtures import build_both, write_fixture

import relativitypathtracer_tpu_torch as pt

_OBJECT_FIELDS = ("m", "inv_m", "velocity", "color", "obj_type", "mesh_root", "tex_offset",
                  "tex_w", "tex_h", "light", "flash_period", "flash_duration")
_MESH_FIELDS = ("vertices", "tri_v", "tri_uv", "tri_n", "uvs", "normals", "node_min",
                "node_max", "node_tris_index", "node_tris_count", "node_children",
                "node_neighbors", "oct_tris")
_STATIC_FIELDS = ("attrs", "spheres", "gen_cols", "gen_spheres")
_TOP_FIELDS = ("textures", "textures_packed", "tex_quads", "tex_fp", "white_point", "ambient")
_META_FIELDS = ("num_objects", "sphere_ids", "cube_ids", "mesh_ids", "mesh_roots",
                "mesh_tri_ranges", "mesh_perms", "light_ids", "default_interval", "num_tris",
                "num_nodes", "max_octree_depth", "use_footprint_tex", "any_flash",
                "mesh_chunk_counts")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3))


def _leaf(scene, path):
    obj = scene
    for part in path.split("."):
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj


_PATHS = ([f"objects.{f}" for f in _OBJECT_FIELDS] + [f"mesh.{f}" for f in _MESH_FIELDS]
          + [f"mesh_static.0.{f}" for f in _STATIC_FIELDS] + list(_TOP_FIELDS))


@pytest.mark.parametrize("path", _PATHS)
def test_scene_array_equals_jax(both, path):
    (js, _), (ps, _) = both
    want = np.asarray(_leaf(js, path))
    got = _leaf(ps, path)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape, path
    assert np.array_equal(got, want), f"{path}: max diff {np.abs(got - want).max()}"


@pytest.mark.parametrize("field", _META_FIELDS)
def test_scene_meta_field_equals_jax(both, field):
    (_, jm), (_, pm) = both
    assert getattr(pm, field) == getattr(jm, field)


def test_fixture_is_the_slice_configuration(both):
    """One untextured mesh in the VMEM tier and one light sphere, interval -1."""
    _, (ps, pm) = both
    assert pm.sphere_ids == (1,) and pm.mesh_ids == (0,) and pm.light_ids == (1,)
    assert pm.cube_ids == () and pm.textured_ids == () and pm.default_interval == -1
    assert pm.num_tris == 1280 and ps.mesh_static[0].attrs.shape == (1280, 15)
    assert ps.objects.velocity[0].tolist() == [0.5, 0.0, 0.0]


def test_scene_from_numpy_round_trip(both):
    """The JAX package's Scene leaves, carried over, equal the port's own
    build of the same file."""
    import jax

    (js, _), (ps, _) = both
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for path in _PATHS:
        a, b = _leaf(carried, path), _leaf(ps, path)
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_scene_from_numpy_refuses_the_multi_mesh_pool(both):
    """The multi-mesh pool, once refused, now carries over as it is (K9/K10
    read it): every field equal to the JAX package's."""
    import jax

    from relativitypathtracer_tpu.models.scene import MeshBatchStatic

    (js, _), _ = both
    ms = js.mesh_static[0]
    pool = MeshBatchStatic(attrs=ms.attrs, gen_cols=ms.gen_cols, spheres=ms.spheres)
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js._replace(mesh_batch=pool)),
                                  device="cpu")
    for f in ("attrs", "gen_cols", "spheres"):
        assert np.array_equal(getattr(carried.mesh_batch, f).numpy(), np.asarray(getattr(pool, f)))


def test_parse_scene_matrices_match_jax_on_rotations():
    """TRS with non-zero angles: model and inverse matrices within 1e-6."""
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    text = ("Os\n p1,2,3,0.7,0.3,1,0.2,0.5,1.5,2\nOc\n p-1,0.5,4,2.1,1,0,0,1,1,3\n"
            "Oc\n p0,0,5,0,0,1,0,1,1,1\nR\n")
    js, ps = jparse(text), pt.parse_scene(text)
    for a, b in zip(js.objects, ps.objects):
        np.testing.assert_allclose(b.m, a.m, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b.inv_m, a.inv_m, rtol=1e-6, atol=1e-6)
        assert a.obj_type == b.obj_type


def test_textured_scene_atlas_matches_jax(tmp_path):
    """Footprint atlas of two textures (one shared by two objects) through
    both packages' build_scene: every texture array exact."""
    from PIL import Image

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    rng = np.random.default_rng(21)
    for name, (w, h) in (("a.png", (37, 21)), ("b.png", (16, 40))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / name)
    text = ("Ta.png\nTb.png\nOs\n p0,0,5,0,0,1,0,1,1,1\n t0\nOc\n p2,0,6,0.3,0,1,0,1,1,1\n t1\n"
            "Oc\n p-2,0,6,0,0,1,0,1,1,1\n t0\nR\n")
    js, jm = jbuild(jparse(text, str(tmp_path)))
    ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    assert pm.textured_ids == (0, 1, 2) and pm.use_footprint_tex == jm.use_footprint_tex
    for path in ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                 "objects.tex_w", "objects.tex_h"):
        want = np.asarray(_leaf(js, path)).astype(np.int64)
        got = _leaf(ps, path).numpy().astype(np.int64)
        assert np.array_equal(got, want), path
