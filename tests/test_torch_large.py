"""The port's large-mesh tier (K11, K12) against the JAX package: the
two-level list functions (pack_bits, live_chunk_lists2, super_spheres_of,
live_chunk_lists3) on a ragged pool of 45 chunks, the walks' twins against
its Pallas kernels in interpret mode (superchunks of 32, and of 128 with the
super-sphere cull forced), and 64x64 frames of a forced-large blob and of
forced-large instances (the per-object loop, no pool) against its frames
under LARGE_MODE = True.

Tolerances: list orders, counts and bits equal, floors within 1e-6; walk t
rtol 1e-5, triangle ids equal on at least 99.9% of hits, u and v within
1e-5 (the same input rays on both sides, as the K5 test), attributes atol
1e-4 (the TPU's hi/lo bf16 products against the port's fp32 row), lit masks
equal; frames the parity rule of utils/parity.py (at most 0.2% of pixels
off by more than 1e-3), a mean difference under 1e-4, equal hit and
shadow-ray counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import (
    assert_frame_parity, build_both, jax_frame, port_frame, soup, t, tie_flip_frac, write_fixture)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu.models.scene import MeshArrays as JMeshArrays
from relativitypathtracer_tpu.ops import mesh_intersect as jmi
from relativitypathtracer_tpu.ops.pallas import mesh_kernels as jmk
from relativitypathtracer_tpu.ops.pallas import mesh_large as jml
from relativitypathtracer_tpu_torch.ops import mesh_intersect as pmi
from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk
from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as pml

STATES = {
    "rest": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)),
    "boosted": ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0)),
}
C_RAGGED = 45


def _list_inputs(seed, C=C_RAGGED, n_pad=2048):
    """C chunk spheres and two blocks of rays from one origin, numpy."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1.5, 1.5, (C, 3)) + np.array([0.0, 0.0, 6.0])
    spheres = np.concatenate([centres, rng.uniform(0.1, 0.5, (C, 1))], axis=1)
    d = rng.normal(size=(3, n_pad)) * 0.15
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    o = np.broadcast_to(rng.uniform(-0.2, 0.2, (3, 1)), (3, n_pad))
    return spheres.astype(np.float32), d.astype(np.float32), np.array(o, np.float32)


def test_pack_bits_matches_jax():
    """The same int32 words, bit 31 on the sign bit, for a ragged width."""
    ov = np.random.default_rng(0).uniform(size=(5, C_RAGGED)) < 0.5
    ov[:, 31] = True  # a set sign bit
    want = np.asarray(jmk.pack_bits(jnp.asarray(ov)))
    got = pmk.pack_bits(t(ov)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want) and (got < 0).any()


def test_super_spheres_of_matches_jax():
    spheres = _list_inputs(1)[0]
    for s in (4, 128):
        np.testing.assert_allclose(pmk.super_spheres_of(t(spheres), s).numpy(),
                                   np.asarray(jmk.super_spheres_of(jnp.asarray(spheres), s)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [4, 128])
@pytest.mark.parametrize("lists_fn", ["live_chunk_lists2", "live_chunk_lists3"])
def test_two_level_lists_match_jax(lists_fn, s):
    """Order, counts and bits equal, floors within 1e-6, on C = 45 with
    masked lanes and a lane bound (the shadow walk's inputs)."""
    spheres, d, o = _list_inputs(2)
    rng = np.random.default_rng(3)
    valid = rng.uniform(size=d.shape[1]) < 0.8
    bound = rng.uniform(3.0, 9.0, d.shape[1]).astype(np.float32)
    jo, jmn, jc, jb = (np.asarray(x) for x in getattr(jmk, lists_fn)(
        jnp.asarray(spheres), jnp.asarray(d), jnp.asarray(o), jnp.asarray(valid),
        jnp.asarray(bound), s=s))
    po, pmn, pc, pb = (x.numpy() for x in getattr(pmk, lists_fn)(
        t(spheres), t(d), t(o), t(valid), t(bound), s=s))
    jo, jmn, jc, jb = jo[:, 0], jmn[:, 0], jc[:, 0, 0], jb[:, 0]
    assert pc.sum() > 0 and np.array_equal(pc, jc) and np.array_equal(pb, jb)
    # lists3 pads the bit columns to whole supers: the cursor reaches them
    width = -(-C_RAGGED // s) * s if lists_fn == "live_chunk_lists3" else C_RAGGED
    assert pb.shape[1] == -(-width // 32)
    live = np.arange(jo.shape[1])[None, :] < jc[:, None]
    assert np.array_equal(po[live], jo[live])
    np.testing.assert_allclose(pmn[live], jmn[live], rtol=1e-6, atol=1e-6)


def _mesh(rng, T):
    verts, tri_v = soup(rng, T)
    z = np.zeros((T, 3), np.int32)
    return JMeshArrays(verts + np.array([0.0, 0.0, 6.0], np.float32), tri_v, z, z,
                       np.zeros((1, 2), np.float32), np.ones((1, 3), np.float32),
                       *([None] * 7))


@pytest.fixture
def xl(request, monkeypatch):
    """Superchunks of 128 through the super-sphere cull, in both packages,
    when the test's `xl` parameter says so. The JAX package reads
    SUPER_CULL_C when it traces, so its jitted large-tier wrappers are
    traced afresh before and after."""
    if request.param:
        monkeypatch.setattr(jml, "SUPER_CULL_C", 0)
        monkeypatch.setattr(pml, "SUPER_CULL_C", 0)
    for fn in (jml.large_shared_nearest_hit, jml.large_general_min_t):
        fn.clear_cache()
    yield request.param
    for fn in (jml.large_shared_nearest_hit, jml.large_general_min_t):
        fn.clear_cache()


@pytest.mark.parametrize("xl", [False, True], ids=["s32", "s128"], indirect=True)
def test_large_shared_walk_matches_interpret_kernel(xl):
    """T = 3,000 triangles (T_pad 3,072, 96 chunks, the last 24 triangles
    masked by T), rays from one origin. Each variant has its own lane count,
    so the JAX wrapper traces it afresh under the patched constant."""
    rng = np.random.default_rng(11)
    T, n = 3000, 2500 + 100 * xl
    mesh = _mesh(rng, T)
    ro = np.array([0.1, -0.1, 0.0], np.float32)
    d = rng.normal(size=(3, n)) * 0.3
    d[2] = 1.0
    dh = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    perm = jnp.arange(T, dtype=jnp.int32)
    consts, c_t, _, T_pad = jmi.shared_origin_constants(mesh, (0, T), jnp.asarray(ro), perm)
    A, B, C = jmi.mesh_tri_vertices(mesh, (0, T), perm)
    spheres = jmk.chunk_spheres(A, B, C, T, T_pad)
    attrs = rng.normal(size=(T_pad, 15)).astype(np.float32)
    want = jml.large_shared_nearest_hit(
        jml.pack_shared_records(consts, T_pad),
        jml.pack_attr_records(jmk.split_bf16(jnp.asarray(attrs)), T_pad), spheres,
        jnp.asarray(dh), jnp.asarray(ro), T=T, interpret=True)
    jt, ju, jv, jtri, jattr = (np.asarray(x) for x in want)
    got = pml.large_shared_nearest_hit(t(consts), t(c_t), t(attrs), t(spheres), t(dh), t(ro), T)
    pt_, pu, pv, ptri, pattr = (x.numpy() for x in got)
    hit = jtri >= 0
    assert hit.mean() > 0.2 and np.array_equal(ptri >= 0, hit)
    assert tie_flip_frac(ptri, jtri) <= 1e-3
    same = hit & (ptri == jtri)
    np.testing.assert_allclose(pt_[hit], jt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu[same], ju[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv[same], jv[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pattr[:, same], jattr[:, same], atol=1e-4)


@pytest.mark.parametrize("xl", [False, True], ids=["s32", "s128"], indirect=True)
def test_large_general_walk_matches_interpret_kernel(xl):
    """Shadow rays with per-lane origins through the soup, tmax/tcut as
    mesh_min_t_general makes them, a fifth of the lanes masked: equal lit
    masks, both verdicts present, and the result min(hit, tmax)."""
    rng = np.random.default_rng(12)
    T, n = 3000, 2500 + 100 * xl
    mesh = _mesh(rng, T)
    d = rng.normal(size=(3, n)) * 0.3
    d[2] = 1.0
    dh = d / np.linalg.norm(d, axis=0)
    ro = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n), np.zeros(n)])
    mom = np.cross(ro.T, dh.T).T
    r10 = np.concatenate([dh, mom, ro, np.ones((1, n))]).astype(np.float32)
    tmax = rng.uniform(4.0, 9.0, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    tmax_obj = np.where(valid, tmax * 1.001 + 1e-3, 0.0).astype(np.float32)
    tcut_obj = np.where(valid, np.maximum(tmax * 0.999 - 1e-3, 0.0), 0.0).astype(np.float32)
    cols, _, T_pad = jmi.general_ray_constants(mesh, (0, T), jnp.arange(T, dtype=jnp.int32))
    A, B, C = jmi.mesh_tri_vertices(mesh, (0, T), jnp.arange(T, dtype=jnp.int32))
    spheres = jmk.chunk_spheres(A, B, C, T, T_pad)
    want = np.asarray(jml.large_general_min_t(
        jml.pack_general_records(cols, T_pad), spheres, jnp.asarray(r10),
        jnp.asarray(tmax_obj), valid=jnp.asarray(valid), tcut_obj=jnp.asarray(tcut_obj), T=T,
        interpret=True))
    got = pml.large_general_min_t(pmk.general_tri_rows(t(cols)), t(spheres), t(r10),
                                  t(tmax_obj), t(valid), t(tcut_obj), T).numpy()
    lit_j, lit_p = want >= tmax, got >= tmax
    assert np.array_equal(lit_p[valid], lit_j[valid])
    assert (~lit_j[valid]).sum() > 100 and lit_j[valid].sum() > 100
    assert np.all(got <= tmax_obj)


def test_super_cursor_skips_dead_and_padded_chunks():
    """The cursor written out: supers in list order, each super's chunks in
    id order, dead bits and ids at or past C skipped, each with its super's
    floor."""
    order = torch.tensor([[1, 0]], dtype=torch.int32)
    minds = torch.tensor([[2.0, 1.0]])
    counts = torch.tensor([2], dtype=torch.int32)
    bits = pmk.pack_bits(torch.tensor([[True, False, True, True, True, False]]))
    chunks, floors, n_live = pml.super_cursor_lists(order, minds, counts, bits, 4, 6)
    assert int(n_live[0]) == 4
    assert chunks[0, :4].tolist() == [4, 0, 2, 3]
    assert floors[0, :4].tolist() == [1.0, 2.0, 2.0, 2.0]


def test_super_cursor_ends_at_the_list_end_when_every_super_is_live():
    """The one-past-end read that the JAX package's cursor guards against
    (its clamp in mesh_large._walk_scaffold): every super of the block live
    and the ragged last one (2 of 4 chunks below C) last in the list, so the
    cursor ends exactly at the list's end. It yields every real chunk once,
    in order, each with its super's floor, and nothing at or past C."""
    order = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    minds = torch.tensor([[1.0, 2.0, 3.0]])
    counts = torch.tensor([3], dtype=torch.int32)
    bits = pmk.pack_bits(torch.ones((1, 10), dtype=torch.bool))
    chunks, floors, n_live = pml.super_cursor_lists(order, minds, counts, bits, 4, 10)
    assert chunks.shape == (1, 12) and int(n_live[0]) == 10
    assert chunks[0, :10].tolist() == list(range(10))
    assert floors[0, :10].tolist() == [1.0] * 4 + [2.0] * 4 + [3.0] * 2


def test_large_fixture_is_the_large_tier():
    """The "large" fixture's mesh: 327,680 triangles, so T_pad 327,680 and
    10,240 chunks in 320 superchunks of 32 (the chunk-level cull, not the
    super-sphere one)."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import LARGE_LEVEL, blob_mesh

    _, faces, _ = blob_mesh(LARGE_LEVEL)
    T_pad = pmi.padded_tri_count(len(faces))
    C = T_pad // pmk.TC
    assert len(faces) == T_pad == 327680 and T_pad > pml.LARGE_T
    assert C == 10240 and pml._super_s(C) == 32 and C // 32 == 320


def test_subdivided_scene_matches_jax(tmp_path):
    """make_subdivided_scene writes the JAX package's files."""
    from relativitypathtracer_tpu.utils import subdiv as jsub
    from relativitypathtracer_tpu_torch.utils import subdiv as psub
    from relativitypathtracer_tpu_torch.utils.demo_scene import blob_mesh

    verts, faces, _ = blob_mesh(1)
    src = tmp_path / "src.obj"
    psub.write_obj(str(src), verts, faces)
    assert psub._parse_obj_vf(str(src)) == jsub._parse_obj_vf(str(src))
    a = psub.make_subdivided_scene(str(src), 2, str(tmp_path / "port"))
    b = jsub.make_subdivided_scene(str(src), 2, str(tmp_path / "jax"))
    for rel in ("Scenes/scene.txt", "Models/big.obj"):
        pa = tmp_path / "port" / "subdiv_src_2" / rel
        assert pa.read_text() == (tmp_path / "jax" / "subdiv_src_2" / rel).read_text()
    assert a.endswith("subdiv_src_2/Scenes/scene.txt") and b.endswith(a[-30:])


def _build_large(path):
    """Both packages' scenes of `path`, each built under its LARGE_MODE."""
    jmi.LARGE_MODE = pmi.LARGE_MODE = True
    try:
        return build_both(path)
    finally:
        jmi.LARGE_MODE = pmi.LARGE_MODE = None


@pytest.fixture(scope="module")
def large_blob(tmp_path_factory):
    return _build_large(write_fixture(tmp_path_factory, 3))


@pytest.fixture(scope="module")
def large_instances(tmp_path_factory):
    return _build_large(write_fixture(tmp_path_factory, 2, "instances"))


@pytest.mark.parametrize("xl", [False, True], ids=["s32", "s128"], indirect=True)
@pytest.mark.parametrize("state", list(STATES))
def test_forced_large_blob_frame_matches_jax(large_blob, state, xl, monkeypatch):
    """The blob at level 3 (1,280 triangles, 40 chunks) through K11 and K12
    on both sides, never through K5/K6: in 2 supers of 32 (lists2), and
    with the super-sphere cull forced (lists3, the XL tier's route) in one
    ragged super of 128."""
    (js, jm), (ps, pm) = large_blob
    assert js.mesh_static[0].gen_rec is not None and ps.mesh_static[0].gen_rec is not None
    calls = []
    for name in ("large_shared_walk", "large_general_walk"):
        real = getattr(pml, name)
        monkeypatch.setattr(pml, name, lambda *a, _r=real, _n=name: calls.append(
            (_n, a[-3], a[0].shape[1])) or _r(*a))
    for name in ("shared_walk", "general_walk"):
        monkeypatch.setattr(pmk, name, lambda *a, _n=name: calls.append(_n))
    want, jaux = jax_frame(js, jm, STATES[state], large=True)
    got, paux = port_frame(ps, pm, STATES[state])
    S, n_super = (128, 1) if xl else (32, 2)
    assert sorted(calls) == [("large_general_walk", S, n_super), ("large_shared_walk", S, n_super)]
    assert_frame_parity(got, want, paux, jaux)
    assert paux["hits"] > 200 and 0 < paux["lit_rays"] < paux["shadow_rays"]


def test_forced_large_instances_frame_matches_jax(large_instances):
    """Four forced-large instances: no pool on either side, so each object
    walks on its own through K11/K12."""
    (js, jm), (ps, pm) = large_instances
    assert js.mesh_batch is None and ps.mesh_batch is None and pm.mesh_chunk_counts == ()
    assert all(ms.gen_rec is not None for ms in ps.mesh_static)
    want, jaux = jax_frame(js, jm, STATES["boosted"], large=True)
    got, paux = port_frame(ps, pm, STATES["boosted"])
    assert_frame_parity(got, want, paux, jaux)
    assert paux["hits"] > 300 and 0 < paux["lit_rays"] < paux["shadow_rays"]


def test_scene_from_numpy_carries_the_large_tier(large_blob):
    """The JAX package's large-tier Scene (lane-major records), carried
    over, renders the frame the port's own build renders."""
    (js, _), (ps, pm) = large_blob
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert torch.equal(carried.mesh_static[0].gen_rec, ps.mesh_static[0].gen_rec)
    a, aaux = port_frame(carried, pm, STATES["boosted"])
    b, baux = port_frame(ps, pm, STATES["boosted"])
    assert np.array_equal(a, b) and aaux == baux


def test_large_mode_is_read_at_scene_build(tmp_path):
    """LARGE_MODE: True builds every mesh for the large tier; None (and
    False, as in the JAX package's scene build) only above LARGE_T."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    host = pt.load_scene_file(write_demo_scene(str(tmp_path), 2))
    for mode, large in ((None, False), (False, False), (True, True)):
        pmi.LARGE_MODE = mode
        try:
            scene, _ = pt.build_scene(host, device="cpu")
        finally:
            pmi.LARGE_MODE = None
        assert (scene.mesh_static[0].gen_rec is not None) == large


@pytest.mark.parametrize("s", [32, 128])
def test_ragged_super_sphere_floors_stay_finite(s):
    """The large tier's INF-radius super-sphere floors: a ragged last group
    (C = 45 chunks in groups of s) masks its pad entries out of its sphere,
    so its radius is the farthest real child's surface (finite, every child
    inside), and the floor of that super in live_chunk_lists3 is a positive
    distance, as in the JAX package; a radius of INF would floor it at 0 and
    keep every block walking to it."""
    spheres, d, o = _list_inputs(4)
    sup = pmk.super_spheres_of(t(spheres), s).numpy()
    last = sup[-1]
    first = (len(sup) - 1) * s
    children = spheres[first:]
    assert np.isfinite(sup).all() and last[3] < 10.0
    assert np.all(np.linalg.norm(children[:, :3] - last[:3], axis=1) + children[:, 3]
                  <= last[3] * (1 + 1e-6))
    np.testing.assert_allclose(sup, np.asarray(jmk.super_spheres_of(jnp.asarray(spheres), s)),
                               rtol=1e-6, atol=1e-6)
    po, pmn, pc, _ = pmk.live_chunk_lists3(t(spheres), t(d), t(o), s=s)
    jo, jmn, jc, _ = (np.asarray(x) for x in jmk.live_chunk_lists3(
        jnp.asarray(spheres), jnp.asarray(d), jnp.asarray(o), s=s))
    last_id = len(sup) - 1
    listed = po.numpy() == last_id
    assert listed.any()
    floors = pmn.numpy()[:, last_id]
    assert np.isfinite(floors).all() and (floors > 0).all()
    np.testing.assert_allclose(floors, jmn[:, 0, last_id], rtol=1e-6)
