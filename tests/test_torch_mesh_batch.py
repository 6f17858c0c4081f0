"""The port's batched mesh walks (K9, K10) and the several-mesh path against
the JAX package: the twins against its Pallas kernels in interpret mode on
random soups of 2 and 8 objects, the fused live lists, and 64x64 frames of
the `instances` fixture (four instances of one mesh: the pool, per-object
scales, motion and a texture) against its frames in interpret and jnp mode.

Tolerances: hit masks, object slots and lit masks equal; t rtol 1e-5;
triangle ids equal on at least 99.9% of hits (exact ties may flip); u and
v no further from float64 than twice the JAX package's error (FMA
contraction, see the test); the winner's attributes atol 1e-4 (the TPU
selects them through hi/lo bf16 products, about |x| * 2^-16; the port reads
the fp32 row). Frames: torch_port_fixtures.assert_frame_parity (the parity
rule of utils/parity.py, a mean difference under 1e-4, equal hit and
shadow-ray counts).
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
from relativitypathtracer_tpu.ops.pallas import mesh_batch as jmb
from relativitypathtracer_tpu.ops.pallas import mesh_kernels as jmk
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.ops import relmath
from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as pmb

STATES = {
    "rest": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)),
    "boosted": ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0)),
}


def _objects(rng, O, T):
    """O random soups, each placed in front of the camera with its own
    rotation, non-uniform scale and velocity: per object (mesh, m, inv_m,
    L) as float32 numpy."""
    out = []
    for g in range(O):
        verts, tri_v = soup(rng, T)
        z = np.zeros((T, 3), np.int32)
        mesh = JMeshArrays(verts * 0.5, tri_v, z, z, np.zeros((1, 2), np.float32),
                           np.ones((1, 3), np.float32), *([None] * 7))
        zpos = rng.uniform(6.0, 10.0)
        pos = np.array([rng.uniform(-0.1, 0.1) * zpos, rng.uniform(-0.08, 0.08) * zpos, zpos],
                       np.float32)
        m = relmath.trs(pos, np.float32(rng.uniform(0, 3)), rng.normal(size=3).astype(np.float32),
                        rng.uniform(0.6, 1.4, 3).astype(np.float32))
        L = relmath.lorentz(torch.as_tensor(rng.normal(size=3) * 0.05, dtype=torch.float32))
        out.append((mesh, m.numpy(), relmath.inverse4(m).numpy(), L.numpy()))
    return out


def _dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32) * 0.1
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([np.full((1, n), -1.0, np.float32), d]).astype(np.float32)


def _mat_row(L, inv_m, m, ro):
    A = inv_m[:3, :3] @ L[1:4, :]
    return np.concatenate([A.reshape(12), inv_m[:3, 3], ro, m[:3, :3].reshape(9),
                           L[1:4, :].reshape(12), np.zeros(1)]).astype(np.float32)


def _object_frame(m, inv_m, L, o4, d4):
    """(ro, dh, s) of camera 4-origins o4 (4,) or (4, n) and 4-dirs d4."""
    od, dd = L @ o4, L @ d4
    ro = (inv_m[:3, :3] @ od[1:4] + (inv_m[:3, 3] if od.ndim == 1 else inv_m[:3, 3, None]))
    d = inv_m[:3, :3] @ dd[1:4]
    dh = d / np.linalg.norm(d, axis=0)
    s = np.linalg.norm(m[:3, :3] @ dh, axis=0) / np.linalg.norm(dd[1:4], axis=0)
    return ro.astype(np.float32), dh.astype(np.float32), s.astype(np.float32)


def _shared_inputs(seed, O, T=200, n=3072):
    """The inputs of batched_nearest_shared for O random objects."""
    rng = np.random.default_rng(seed)
    objs = _objects(rng, O, T)
    dir4 = _dirs(rng, n)
    cam = np.array([0.3, 0.1, -0.1, 0.0], np.float32)
    factors, attrs, spheres, boxes, mats, d_os, o_os, s_os, counts = ([], [], [], []), [], [], \
        [], [], [], [], [], []
    for mesh, m, inv_m, L in objs:
        ro, dh, s = _object_frame(m, inv_m, L, cam, dir4)
        perm = jnp.arange(T, dtype=jnp.int32)
        consts, _, _, T_pad = jmi.shared_origin_constants(mesh, (0, T), jnp.asarray(ro), perm)
        consts = np.asarray(consts)
        for f in range(4):
            factors[f].append(consts[f * T_pad:(f + 1) * T_pad])
        A, B, C = jmi.mesh_tri_vertices(mesh, (0, T), perm)
        sph = np.asarray(jmk.chunk_spheres(A, B, C, T, T_pad))
        spheres.append(sph)
        attrs.append(rng.normal(size=(T_pad, 15)).astype(np.float32))
        boxes.append(np.concatenate([(sph[:, :3] - sph[:, 3:4]).min(0),
                                     (sph[:, :3] + sph[:, 3:4]).max(0), ro]))
        mats.append(_mat_row(L, inv_m, m, ro))
        d_os.append(dh)
        o_os.append(np.broadcast_to(ro[:, None], (3, n)))
        s_os.append(s)
        counts.append(T_pad // jmk.TC)
    return (np.concatenate(sum(factors, [])), np.concatenate(attrs), np.concatenate(spheres),
            np.stack(boxes).astype(np.float32), np.stack(mats), dir4, np.stack(d_os),
            np.stack(o_os).astype(np.float32), np.stack(s_os), tuple(counts))


def _barycentrics64(args, obj, tri, lanes):
    """Float64 (u, v) of the given lanes' winning pool triangles, their rays
    derived from the mats table as the kernels derive them."""
    consts, mats, dir4 = (np.asarray(args[i], np.float64) for i in (0, 4, 5))
    T = consts.shape[0] // 4
    d = np.einsum("lij,jl->il", mats[obj, 0:12].reshape(-1, 3, 4), dir4[:, lanes])
    dh = d / np.linalg.norm(d, axis=0)
    det, un, vn = (np.einsum("lc,cl->l", consts[f * T + tri], dh) for f in range(3))
    return un / det, vn / det


@pytest.mark.parametrize("O", [2, 8])
def test_batched_shared_walk_matches_interpret_kernel(O):
    args = _shared_inputs(20 + O, O)
    want = jmb.batched_nearest_shared(*[jnp.asarray(a) for a in args[:-1]], args[-1],
                                      interpret=True)
    jt, ju, jv, jtri, jobj, jattr = (np.asarray(x) for x in want)
    got = pmb.batched_nearest_shared(*[t(a) for a in args[:-1]], args[-1])
    pt_, pu, pv, ptri, pobj, pattr = (x.numpy() for x in got)
    hit = jtri >= 0
    assert hit.mean() > 0.1 and np.array_equal(ptri >= 0, hit)
    assert len(set(jobj[hit])) == O  # every object wins somewhere
    assert np.array_equal(pobj, jobj)
    assert tie_flip_frac(ptri, jtri) <= 1e-3
    same = hit & (ptri == jtri)
    np.testing.assert_allclose(pt_[hit], jt[hit], rtol=1e-5, atol=0)
    # u, v: each side derives the object-frame rays from the mats table, and
    # XLA on the CPU contracts those sums into FMAs while the port rounds
    # twice (as the card does under -fmad=false); near-singular triangles
    # magnify that last bit (about 1% of hits differ by more than 1e-5). So
    # both are held to float64 barycentrics: the port's error at most twice
    # the JAX package's.
    u64, v64 = _barycentrics64(args, jobj[same], jtri[same], np.nonzero(same)[0])
    for got_, want_, exact in ((pu, ju, u64), (pv, jv, v64)):
        assert np.abs(got_[same] - exact).max() <= 2 * np.abs(want_[same] - exact).max() + 1e-7
    np.testing.assert_allclose(pattr[:, same], jattr[:, same], atol=1e-4)
    assert np.all(pattr[:, ~hit] == 0.0) and np.all(pobj[~hit] == -1)


def _general_inputs(seed, O, T=200, n=3072):
    """The inputs of batched_min_t_general for O random objects, object 1
    disabled (as the light's own mesh is for its shadow rays)."""
    rng = np.random.default_rng(seed)
    objs = _objects(rng, O, T)
    dir4 = _dirs(rng, n)
    origins4 = np.stack([rng.uniform(0.0, 0.5, n), rng.uniform(-1.0, 1.0, n),
                         rng.uniform(-1.0, 1.0, n), rng.uniform(0.0, 5.0, n)]).astype(np.float32)
    factors, spheres, mats, d_os, o_os, s_os, counts = ([], [], [], []), [], [], [], [], [], []
    for mesh, m, inv_m, L in objs:
        ro, dh, s = _object_frame(m, inv_m, L, origins4, dir4)
        perm = jnp.arange(T, dtype=jnp.int32)
        cols, _, T_pad = jmi.general_ray_constants(mesh, (0, T), perm)
        cols = np.asarray(cols)
        for f in range(4):
            factors[f].append(cols[f * T_pad:(f + 1) * T_pad])
        A, B, C = jmi.mesh_tri_vertices(mesh, (0, T), perm)
        spheres.append(np.asarray(jmk.chunk_spheres(A, B, C, T, T_pad)))
        mats.append(_mat_row(L, inv_m, m, np.zeros(3, np.float32)))
        d_os.append(dh)
        o_os.append(ro)
        s_os.append(s)
        counts.append(T_pad // jmk.TC)
    tmax = rng.uniform(2.0, 14.0, n).astype(np.float32)
    tmax[rng.uniform(size=n) < 0.2] = 0.0
    enabled = tuple(g != 1 for g in range(O))
    return (np.concatenate(sum(factors, [])), np.concatenate(spheres), np.stack(mats),
            origins4, dir4, np.stack(d_os), np.stack(o_os), np.stack(s_os), tmax,
            tuple(counts), enabled)


@pytest.mark.parametrize("O", [2, 8])
def test_batched_general_walk_matches_interpret_kernel(O):
    """Equal lit masks on the lanes with tmax > 0, both verdicts present,
    the result min(hit, tmax); a disabled object occludes nothing."""
    *arrays, counts, enabled = _general_inputs(30 + O, O)
    tmax = arrays[-1]
    valid = tmax > 0
    want = np.asarray(jmb.batched_min_t_general(
        *[jnp.asarray(a) for a in arrays], counts, enabled=enabled, valid=jnp.asarray(valid),
        interpret=True))
    got = pmb.batched_min_t_general(*[t(a) for a in arrays], counts, enabled=enabled,
                                    valid=t(valid)).numpy()
    assert np.array_equal((got >= tmax)[valid], (want >= tmax)[valid])
    assert (want < tmax)[valid].sum() > 50 and (want >= tmax)[valid].sum() > 50
    assert np.all(got <= tmax)
    # with every object enabled, more lanes are occluded
    every = pmb.batched_min_t_general(*[t(a) for a in arrays], counts, valid=t(valid)).numpy()
    assert (every < tmax)[valid].sum() > (got < tmax)[valid].sum()


def test_batched_min_t_general_makes_no_host_tensor_after_the_first_call(monkeypatch):
    """The pool's tables and boxes, the stand-in box of the disabled object
    among them, are made once (a CUDA graph's capture refuses a tensor made
    from host data): a second call with torch.tensor raising gives the same
    result."""
    *arrays, counts, enabled = _general_inputs(60, 3)
    args = [t(a) for a in arrays]
    valid = args[-1] > 0
    first = pmb.batched_min_t_general(*args, counts, enabled=enabled, valid=valid)

    def refuse(*a, **k):
        raise AssertionError("torch.tensor after the first call")

    monkeypatch.setattr(torch, "tensor", refuse)
    assert torch.equal(pmb.batched_min_t_general(*args, counts, enabled=enabled, valid=valid),
                       first)


def test_pool_boxes_equal_the_per_object_boxes():
    """One pass over the pool gives each object's union box of its chunk
    spheres to the bit (a min and a max are exact in any order)."""
    from relativitypathtracer_tpu_torch.ops.kernels.mesh_kernels import _box_of

    _, spheres, *_, counts, _ = _general_inputs(61, 4)
    spheres = t(spheres)
    got, c0 = pmb.pool_boxes(spheres, counts), 0
    for g, c in enumerate(counts):
        assert torch.equal(got[g], torch.cat(_box_of(spheres[c0:c0 + c])))
        c0 += c


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_live_chunk_lists_multi_matches_jax(shadow):
    """counts and the live sets exact; order and floors where the floors
    agree (a 1-ulp difference of a cone reduction may move a chunk across a
    bucket edge: at most 1% of live entries); floors within 1e-6."""
    if shadow:
        _, spheres, _, _, _, d_os, o_os, s_os, tmax, counts, enabled = _general_inputs(41, 3)
        valid = tmax > 0
        extra = dict(valid=valid, enabled=enabled, lane_bound_shared=tmax)
    else:
        _, _, spheres, _, _, _, d_os, o_os, s_os, counts = _shared_inputs(40, 3)
        extra = {}
    jo, jmn, jc = (np.asarray(x) for x in jmb.live_chunk_lists_multi(
        jnp.asarray(spheres), counts, jnp.asarray(d_os), jnp.asarray(o_os), jnp.asarray(s_os),
        **{k: v if k == "enabled" else jnp.asarray(v) for k, v in extra.items()}))
    po, pmn, pc = (x.numpy() for x in pmb.live_chunk_lists_multi(
        t(spheres), counts, t(d_os), t(o_os), t(s_os),
        **{k: v if k == "enabled" else t(v) for k, v in extra.items()}))
    jo, jmn, jc = jo[:, 0, :], jmn[:, 0, :], jc[:, 0, 0]
    assert np.array_equal(pc, jc) and jc.sum() > 0
    live = np.arange(jo.shape[1])[None, :] < jc[:, None]
    for b in range(jo.shape[0]):
        assert set(po[b, live[b]]) == set(jo[b, live[b]])
    assert np.mean(po[live] != jo[live]) <= 0.01
    rows = np.arange(jo.shape[0])[:, None]
    np.testing.assert_allclose(pmn[rows, po][live], jmn[rows, jo][live], rtol=1e-6, atol=1e-6)


def test_object_rays_match_the_kernels_ray_derivation():
    """The twins' per-object rays (the kernels' operations in their order)
    against the same rays computed by the JAX package's frame algebra in
    float64: the scale s within 1e-5 relative, dirs and origins within
    1e-5."""
    *arrays, counts, enabled = _general_inputs(50, 3)
    mats, origins4, dir4 = (t(a) for a in arrays[2:5])
    r10, s = pmb.object_rays(mats, origins4, dir4)
    for g in range(3):
        np.testing.assert_allclose(r10[g, 0:3].numpy(), arrays[5][g], atol=1e-5)
        np.testing.assert_allclose(r10[g, 6:9].numpy(), arrays[6][g], atol=1e-5)
        np.testing.assert_allclose(s[g].numpy(), arrays[7][g], rtol=1e-5)
    assert torch.equal(r10[:, 9], torch.ones_like(r10[:, 9]))


@pytest.fixture(scope="module")
def instances(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 2, "instances"))


@pytest.mark.parametrize("mode", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("state", list(STATES))
def test_instances_frame_matches_jax(instances, mode, state):
    """The JAX frame through K9/K10 in interpret mode, or its per-object jnp
    loop; the port's through the twins of its batched kernels."""
    (js, jm), (ps, pm) = instances
    want, jaux = jax_frame(js, jm, STATES[state], mode)
    got, paux = port_frame(ps, pm, STATES[state])
    assert_frame_parity(got, want, paux, jaux)
    assert paux["hits"] > 300 and 0 < paux["lit_rays"] < paux["shadow_rays"]


def test_instances_scene_matches_jax(instances):
    """Four instances of one 320-triangle mesh (T_pad 512): one pool of 4 x
    16 chunks, every pool array equal to the JAX package's; the textured one
    is the fourth."""
    (js, jm), (ps, pm) = instances
    assert pm.mesh_ids == (0, 1, 2, 3) and pm.textured_ids == (3,) and pm.light_ids == (4,)
    assert pm.mesh_chunk_counts == jm.mesh_chunk_counts == (16, 16, 16, 16)
    for f in ("attrs", "gen_cols", "spheres"):
        assert np.array_equal(getattr(ps.mesh_batch, f).numpy(),
                              np.asarray(getattr(js.mesh_batch, f))), f
    speeds = torch.linalg.vector_norm(ps.objects.velocity[:4], dim=1).tolist()
    assert speeds == pytest.approx([0.0, 0.5, 0.7, 0.0])


def test_instances_take_the_batched_walks(instances, monkeypatch):
    """The frame goes through K9 once and K10 once per light, never through
    the one-mesh walks; and shadow rays from the other instances find
    occluders in the small instance's chunks (leaving it out of the shadow
    walk lights lanes that hit another instance)."""
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as pmi
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk

    _, (ps, pm) = instances
    calls = []
    for mod, name in ((pmb, "batched_shared_walk"), (pmb, "batched_general_walk"),
                      (pmk, "shared_walk"), (pmk, "general_walk")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    port_frame(ps, pm, STATES["rest"])
    assert sorted(calls) == ["batched_general_walk", "batched_shared_walk"]
    monkeypatch.undo()

    hit_obj, occluded = {}, {}
    real_is, real_min_t = prender.intersect_scene, pmi.batched_min_t_general

    def record_hits(*a):
        out = real_is(*a)
        hit_obj["obj"] = out[3]
        return out

    monkeypatch.setattr(prender, "intersect_scene", record_hits)
    for drop in (False, True):
        def spy(*a, enabled=None, valid=None, _drop=drop):
            if _drop:
                enabled = tuple(e and g != 3 for g, e in enumerate(enabled))
            out = real_min_t(*a, enabled=enabled, valid=valid)
            occluded[_drop] = (out < a[8]) & valid  # a[8]: tmax
            return out

        monkeypatch.setattr(pmi, "batched_min_t_general", spy)
        port_frame(ps, pm, STATES["rest"])
    lit_by_dropping = occluded[False] & ~occluded[True]
    assert bool((lit_by_dropping & (hit_obj["obj"] != 3)).any())


def test_scene_from_numpy_carries_the_pool(instances):
    """The JAX package's several-mesh Scene, carried over, renders the frame
    the port's own build_scene renders."""
    (js, _), (ps, pm) = instances
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for f in ("attrs", "gen_cols", "spheres"):
        assert torch.equal(getattr(carried.mesh_batch, f), getattr(ps.mesh_batch, f))
    a, aaux = port_frame(carried, pm, STATES["boosted"])
    b, baux = port_frame(ps, pm, STATES["boosted"])
    assert np.array_equal(a, b) and aaux == baux


def _walk_args(shadow, O=3):
    """The K9 (K10 when shadow) walk arguments of O random objects, as
    batched_nearest_shared (batched_min_t_general) hands them to its walk;
    for K9, block 0's rays look away from every object."""
    seen = {}

    def spy(*a):
        seen["args"] = a
        return real(*a)

    if shadow:
        *arrays, counts, enabled = _general_inputs(60 + O, O)
        real = pmb.batched_general_walk
        pmb.batched_general_walk = spy
        try:
            pmb.batched_min_t_general(*[t(a) for a in arrays], counts, enabled=enabled,
                                      valid=t(arrays[-1] > 0))
        finally:
            pmb.batched_general_walk = real
        return seen["args"]
    args = list(_shared_inputs(70 + O, O))
    args[5][1:, :pmb.NB] = np.array([[0.0], [0.0], [-1.0]], np.float32)
    args = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    args[6], args[8] = pmb.object_dirs(args[4], args[5])
    real = pmb.batched_shared_walk
    pmb.batched_shared_walk = spy
    try:
        pmb.batched_nearest_shared(*args)
    finally:
        pmb.batched_shared_walk = real
    return seen["args"]


def _direct_walk_counts(shadow, args):
    """Each block's walked chunks and object switches, one block at a time:
    the walks' stopping rule written out as a plain loop over the block's
    list (its floors read by chunk id, its bound the max over its lanes of
    min(running min, union-box bound), for K10 with the retirement rule)."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk

    order, minds, counts, cobj, boxes, mats = args[:6]
    walked, switches = [], []
    for b in range(order.shape[0]):
        lanes = slice(b * pmk.NB, (b + 1) * pmk.NB)
        if shadow:
            rows, o4, d4, tmax = args[6], args[7][:, lanes], args[8][:, lanes], args[9][lanes]
            r, s = pmb.object_rays(mats, o4, d4)
            bound = torch.stack([pmk._box_bound(boxes[g, 0:3], boxes[g, 3:6], r[g, 6:9],
                                                r[g, 0:3]) * s[g] for g in range(len(mats))])
            teff = torch.minimum(tmax, bound.amax(dim=0))
            mb = teff.amax()
        else:
            rows, d4 = args[6], args[8][:, lanes]
            dh, s = pmb.object_dirs(mats, d4)
            bound = torch.stack([pmk._box_bound(boxes[g, 0:3], boxes[g, 3:6], boxes[g, 6:9],
                                                dh[g]) * s[g] for g in range(len(mats))]).amax(0)
            mb = bound.amax()
        best = torch.full((pmk.NB,), pmk.INF)
        n, sw, prev = 0, 0, None
        for j in range(int(counts[b])):
            k = int(order[b, j])
            if not bool(minds[b, k] < mb):
                break
            g = int(cobj[k])
            n, sw, prev = n + 1, sw + (prev is not None and g != prev), g
            if shadow:
                c = rows.reshape(-1, pmk.TC, 20)[k:k + 1]
                x = r[g][:, None, :]
                dist, _, _ = pmk._mt(pmk._dot_rows(c, 0, 3, x, 0), pmk._dot_rows(c, 3, 9, x, 0),
                                     pmk._dot_rows(c, 9, 15, x, 0), pmk._dot_rows(c, 15, 19, x, 6))
            else:
                c = rows.reshape(-1, pmk.TC, 10)[k:k + 1]
                x = dh[g][:, None, :]
                dist, _, _ = pmk._mt(pmk._dot_rows(c, 0, 3, x, 0), pmk._dot_rows(c, 3, 6, x, 0),
                                     pmk._dot_rows(c, 6, 9, x, 0), c[:, :, 9:10])
            tsh = torch.where(dist < pmk.INF, dist * s[g][None, None, :], pmk.INF)
            best = torch.minimum(best, tsh.amin(dim=1)[0])
            if shadow:
                mb = torch.where(best < tmax, 0.0, torch.minimum(best, teff)).amax()
            else:
                mb = torch.minimum(best, bound).amax()
        walked.append(n)
        switches.append(sw)
    return walked, switches


@pytest.mark.parametrize("shadow", [False, True], ids=["K9", "K10"])
def test_batched_walks_count_the_walked_chunks(shadow):
    """walked=True returns the same outputs plus each block's walked
    chunks, equal to a count of the walk written out block by block, as are
    object_switches' counts of the object changes along each walk; K9's
    block that looks away walks nothing."""
    args = _walk_args(shadow)
    plain = pmb.batched_general_walk_plain if shadow else pmb.batched_shared_walk_plain
    want = plain(*args)
    *got, walked = plain(*args, walked=True)
    if shadow:
        assert torch.equal(got[0], want)
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    direct, switches = _direct_walk_counts(shadow, args)
    assert walked.tolist() == direct and sum(direct) > 0
    assert pmb.object_switches(args[0], args[3], walked).tolist() == switches
    assert sum(switches) > 0 and bool((walked <= args[2]).all())
    if not shadow:
        assert direct[0] == 0 and bool((want[3][:pmb.NB] == -1).all())


def test_box_plane_lanes_keep_their_walk_in_k9():
    """The 0 * inf slab NaN in K9's per-object box (box_plane_batch): block
    1's rays run along object 0's lo.x plane with an exact-zero x
    direction. Their bound stays the box exit (mesh_kernels._safe_inv), so
    that block walks its list as the others do (a plain reciprocal makes
    the slab NaN, the bound 0 and the walk empty); the twin's outputs match
    the JAX package's interpret kernel on the same inputs."""
    from torch_port_fixtures import box_plane_batch

    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk

    inputs = box_plane_batch("cpu")
    jt, _, _, jtri, jobj, _ = (np.asarray(x) for x in jmb.batched_nearest_shared(
        *[jnp.asarray(x.numpy()) for x in inputs[:-1]], inputs[-1], interpret=True))
    seen = {}
    real = pmb.batched_shared_walk
    pmb.batched_shared_walk = lambda *a: seen.setdefault("args", a) and real(*a)
    try:
        pt_, _, _, ptri, pobj, _ = (x.numpy() for x in pmb.batched_nearest_shared(*inputs))
    finally:
        pmb.batched_shared_walk = real
    hit = jtri >= 0
    assert hit.sum() > 100 and np.array_equal(ptri >= 0, hit) and np.array_equal(pobj, jobj)
    assert tie_flip_frac(ptri, jtri) <= 1e-3
    np.testing.assert_allclose(pt_[hit], jt[hit], rtol=1e-5)
    *_, walked = pmb.batched_shared_walk_plain(*seen["args"], walked=True)
    assert int(walked[1]) > 0
    safe_inv = pmk._safe_inv
    pmk._safe_inv = lambda d: 1.0 / d
    try:
        *_, naive = pmb.batched_shared_walk_plain(*seen["args"], walked=True)
    finally:
        pmk._safe_inv = safe_inv
    assert int(naive[1]) == 0 and naive[0] == walked[0] and naive[2] == walked[2]
