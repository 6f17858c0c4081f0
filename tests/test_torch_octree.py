"""The port's octree walk (ops/octree_traverse.py) against the JAX package's
and against the port's chunk walk.

On the blob fixture's mesh (level 3, 1,280 triangles, at (1, -0.2, 3.2)
scaled 1.25), with the same inputs made with numpy from a seed:
- a fan of 512 rays from the world origin, an origin inside the octree, and
  rays that miss: `octree_intersect` against the JAX package's (jnp, XLA on
  the CPU): the same hit/miss on every ray, t within a relative 1e-5, the
  normal and uv within 1e-4 (XLA contracts products into FMAs, the port
  never does);
- the fan against the port's `mesh_intersect_shared` on the CPU (the plain
  twin of the K5 route): the same hit/miss on at least 99.5% of rays (the
  JAX package's own rule for its walk), t within a relative 1e-4 on rays
  both hit;
- a cap of 4 iterations reports converged False.

And the octree builder: the port's C++ builder (csrc/octree_builder.cpp)
equal to its numpy twin (models/octree.generate_octree_plain) bit for bit
on the cases of torch_port_fixtures.OCTREE_CASES (blob levels 2-5, bunny's
stand-in, both two-mesh orders, one triangle, zero-area triangles);
tests/test_torch_octree_builder.py holds it to the JAX package's builder.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import (
    OCTREE_CASES,
    assert_same_octree,
    build_both,
    octree_case,
    octree_objs,
    write_fixture,
)

from relativitypathtracer_tpu_torch.ops.octree_traverse import octree_intersect
from relativitypathtracer_tpu_torch.render import mesh_perm_tensors


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3))


def _fan(n, seed=11):
    """Directions (3, n) from the world origin around the mesh's centre."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.35, 0.35, (3, n)).astype(np.float32)
    d[0] += 1.0 / 3.2
    d[1] += -0.2 / 3.2
    d[2] = 1.0
    return d


def _inputs(scene, meta):
    i = meta.mesh_ids[0]
    return meta.mesh_roots[0], scene.objects.m[i], scene.objects.inv_m[i]


def _both(blob, o3, d3, **kw):
    from relativitypathtracer_tpu.ops.octree_traverse import octree_intersect as jax_walk

    (js, jm), (ps, pm) = blob
    root, m4, inv_m = _inputs(js, jm)
    want = jax_walk(js.mesh, root, m4, inv_m, jnp.asarray(o3), jnp.asarray(d3), **kw)
    root, m4, inv_m = _inputs(ps, pm)
    got = octree_intersect(ps.mesh, root, m4, inv_m, torch.as_tensor(o3), torch.as_tensor(d3),
                           **kw)
    return [x.numpy() for x in got[:4]] + [got[4]], [np.asarray(x) for x in want]


def _assert_same_walk(got, want):
    (t, n, uv, valid, conv), (wt, wn, wuv, wvalid, wconv) = got, want
    assert conv is True and bool(wconv)
    assert np.array_equal(valid, wvalid)
    np.testing.assert_allclose(t[valid], wt[valid], rtol=1e-5)
    assert (t[~valid] == 1e20).all()
    np.testing.assert_allclose(n[:, valid], wn[:, valid], atol=1e-4)
    np.testing.assert_allclose(uv[:, valid], wuv[:, valid], atol=1e-4)


def test_fan_matches_jax(blob):
    got, want = _both(blob, np.zeros(3, np.float32), _fan(512))
    _assert_same_walk(got, want)
    assert 50 < got[3].sum() < 500  # hits and misses both


def test_origin_inside_matches_jax(blob):
    """An origin at the root box's centre: the inside descent and re-entry
    (opencl_kernel.cl:233-248), whose misses the reference shares."""
    _, (ps, pm) = blob
    root, m4, _ = _inputs(ps, pm)
    centre = ((ps.mesh.node_min[root] + ps.mesh.node_max[root]) / 2).numpy()
    m4 = m4.numpy()
    o3 = (m4[:3, :3] @ centre + m4[:3, 3]).astype(np.float32)
    d3 = (_fan(128, seed=3) - _fan(1)[:, :1] * np.array([[1], [1], [0]], np.float32))
    got, want = _both(blob, o3, d3)
    _assert_same_walk(got, want)
    assert got[3].sum() > 0


def test_all_misses_match_jax(blob):
    d3 = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, 16))
    got, want = _both(blob, np.array([100.0, 100.0, 100.0], np.float32), d3)
    _assert_same_walk(got, want)
    assert not got[3].any()


def test_fan_matches_the_chunk_walk(blob):
    from relativitypathtracer_tpu_torch.ops.mesh_intersect import mesh_intersect_shared

    _, (ps, pm) = blob
    root, m4, inv_m = _inputs(ps, pm)
    o3, d3 = torch.zeros(3), torch.as_tensor(_fan(512))
    stats = {}
    t, _, _, valid, conv = octree_intersect(ps.mesh, root, m4, inv_m, o3, d3, stats=stats)
    assert conv and 0 < stats["iterations"] < 16384
    bt, _, _, bvalid = mesh_intersect_shared(ps.mesh, m4, inv_m, o3, d3,
                                             mesh_perm_tensors(pm, "cpu")[0], ps.mesh_static[0])
    assert float((valid == bvalid).float().mean()) >= 0.995
    both = valid & bvalid
    assert int(both.sum()) > 50
    np.testing.assert_allclose(t[both].numpy(), bt[both].numpy(), rtol=1e-4)


def test_tiny_cap_does_not_converge(blob):
    _, (ps, pm) = blob
    root, m4, inv_m = _inputs(ps, pm)
    stats = {}
    *_, conv = octree_intersect(ps.mesh, root, m4, inv_m, torch.zeros(3),
                                torch.as_tensor(_fan(64)), iteration_cap=4, stats=stats)
    assert conv is False and stats["iterations"] == 4


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    return octree_objs(tmp_path_factory.mktemp("octree_objs"))


@pytest.mark.parametrize("case", list(OCTREE_CASES))
def test_cpp_builder_equals_its_numpy_twin(objs, case):
    assert_same_octree(octree_case(objs, case, "cpp"), octree_case(objs, case, "plain"))
