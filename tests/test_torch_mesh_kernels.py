"""The port's mesh walks (K5, K6) and their live-chunk lists against the JAX
package's Pallas kernels in interpret mode, on a random soup and on the
fixture. The port's plain twins are what a CPU tensor runs.

Tolerances: t rtol 1e-5; triangle ids equal except tie flips (at most 0.1%
of lanes); attributes atol 1e-4 (the TPU selects them through hi/lo bf16
products, about |x| * 2^-16; the port loads the fp32 row); shadow walks by
their lit mask, never raw t (a retired lane may return any hit below tcut).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import (aim_at, build_both, soup, t, tie_flip_frac, tie_soup,
                                 write_fixture)

from relativitypathtracer_tpu.models.scene import MeshArrays as JMeshArrays
from relativitypathtracer_tpu.ops import mesh_intersect as jmi
from relativitypathtracer_tpu.ops.pallas import mesh_kernels as jmk
from relativitypathtracer_tpu_torch.ops import mesh_intersect as pmi
from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk
from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as pml


def _soup_mesh(rng, T, soup_arrays=None):
    """A random soup (or the given (vertices, tri_v)) as the JAX package's
    MeshArrays (no octree)."""
    verts, tri_v = soup(rng, T) if soup_arrays is None else soup_arrays
    z = np.zeros((T, 3), np.int32)
    return JMeshArrays(verts, tri_v, z, z, np.zeros((1, 2), np.float32),
                       np.ones((1, 3), np.float32), *([None] * 7))


@pytest.fixture(scope="module")
def fixture_scenes(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3))


def _shared_inputs(rng, T=300, n=3072, ties=False):
    """Soup constants from the JAX package (fed to both), rays from (0, 0, -6);
    with `ties`, the tie soup and every ray aimed at a repeated triangle."""
    ro = np.array([0.0, 0.0, -6.0], np.float32)
    if ties:
        verts, tri_v, inside, across = tie_soup(rng, T)
        jmesh = _soup_mesh(rng, T, (verts, tri_v))
        d = aim_at(rng, verts, tri_v, rng.choice(np.concatenate([inside, across]), n), ro)
    else:
        jmesh = _soup_mesh(rng, T)
        d = rng.normal(size=(3, n)).astype(np.float32)
        d[2] = np.abs(d[2]) + 0.5
        d /= np.linalg.norm(d, axis=0)
    perm = jnp.arange(T, dtype=jnp.int32)
    consts, c_t, _, T_pad = jmi.shared_origin_constants(jmesh, (0, T), jnp.asarray(ro), perm)
    A, B, C = jmi.mesh_tri_vertices(jmesh, (0, T), perm)
    spheres = jmk.chunk_spheres(A, B, C, T, T_pad)
    rng2 = np.random.default_rng(99)
    attrs = rng2.normal(size=(T_pad, 15)).astype(np.float32)
    return [np.asarray(x) for x in (consts, c_t, spheres)] + [attrs, d, ro]


def _compare_shared(consts, c_t, spheres, attrs, d, ro):
    want = jmk.shared_nearest_hit(consts, c_t, attrs, spheres, d, ro, interpret=True)
    jt, ju, jv, jtri, jattr = (np.asarray(x) for x in want)
    pt_, pu, pv, ptri, pattr = (x.numpy() for x in pmk.shared_nearest_hit(
        t(consts), t(c_t), t(attrs), t(spheres), t(d), t(ro)))
    hit = jtri >= 0
    assert hit.any() and np.array_equal(ptri >= 0, hit)
    same = ptri == jtri
    assert tie_flip_frac(ptri, jtri) <= 1e-3
    np.testing.assert_allclose(pt_[hit], jt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu[same & hit], ju[same & hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv[same & hit], jv[same & hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pattr[:, same], jattr[:, same], atol=1e-4)
    assert np.all(pattr[:, ~hit] == 0.0)


def test_shared_walk_matches_interpret_kernel_on_soup():
    _compare_shared(*_shared_inputs(np.random.default_rng(7)))


def test_shared_walk_ties_match_interpret_kernel():
    """The tie soup (a triangle repeated inside its chunk, another across two
    chunks), every ray aimed at a repeated triangle: the twin's triangle ids
    equal the interpret kernel's on every lane. Inside a chunk the first of
    a pair wins (the first minimum, as jnp.argmin takes it); across two
    chunks the one walked first (strict <)."""
    rng = np.random.default_rng(17)
    consts, c_t, spheres, attrs, d, ro = _shared_inputs(rng, ties=True)
    want = jmk.shared_nearest_hit(consts, c_t, attrs, spheres, d, ro, interpret=True)
    got = pmk.shared_nearest_hit(t(consts), t(c_t), t(attrs), t(spheres), t(d), t(ro))
    jtri, ptri = np.asarray(want[3]), got[3].numpy()
    assert np.array_equal(ptri, jtri)
    _, _, inside, across = tie_soup(np.random.default_rng(17), 300)
    assert np.isin(jtri, inside).mean() > 0.2 and not np.isin(jtri, inside + 1).any()
    assert np.isin(jtri, np.concatenate([across, across + 31])).mean() > 0.2


def test_walk_shared_lists_counts_the_walked_chunks():
    """walked=True also returns each block's walked chunks, at most its live
    count, none for a block whose rays all miss the union box (its lanes
    keep t = INF, tri = -1); the result is the same."""
    consts, c_t, spheres, attrs, d, ro = _shared_inputs(np.random.default_rng(18))
    d[:, :pmk.NB] = np.array([[0.0], [0.0], [-1.0]], np.float32)  # block 0 looks away
    dh_p, sph = t(d), t(spheres)
    order, minds, counts = pmk.live_chunk_lists(sph, dh_p, t(ro)[:, None].expand_as(dh_p))
    lo, hi = pmk._box_of(sph)
    args = (torch.cat([lo, hi, t(ro)]), pmk.shared_tri_rows(t(consts), t(c_t)), t(attrs), dh_p)
    want = pmk.shared_walk_plain(order, minds, counts, *args)
    *got, walked = pmk.walk_shared_lists(order, minds.gather(1, order.long()), counts, *args,
                                         walked=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert walked.tolist()[0] == 0 and int(walked.sum()) > 0
    assert bool((walked <= counts).all())
    assert bool((want[0][:pmk.NB] == pmk.INF).all()) and bool((want[3][:pmk.NB] == -1).all())


def test_shared_walk_matches_interpret_kernel_on_fixture(fixture_scenes):
    """The fixture's mesh seen from its camera event at 64x48 rays."""
    (js, jm), (ps, pm) = fixture_scenes
    static = js.mesh_static[0]
    perm = jnp.asarray(jm.mesh_perms[0], jnp.int32)
    ro = np.array([-1.0, 0.1, -3.0], np.float32) / 1.25
    rng = np.random.default_rng(8)
    d = rng.normal(size=(3, 3072)).astype(np.float32) * 0.25
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    consts, c_t, _, _ = jmi.shared_origin_constants(js.mesh, (0, 0), jnp.asarray(ro), perm)
    _compare_shared(np.asarray(consts), np.asarray(c_t), np.asarray(static.spheres),
                    np.asarray(static.attrs), d, ro)


def test_mesh_constants_match_jax(fixture_scenes):
    (js, jm), (ps, pm) = fixture_scenes
    ro = np.array([0.3, -0.2, -2.5], np.float32)
    jperm = jnp.asarray(jm.mesh_perms[0], jnp.int32)
    pperm = torch.as_tensor(pm.mesh_perms[0])
    jc, jct, jT, jTp = jmi.shared_origin_constants(js.mesh, (0, 0), jnp.asarray(ro), jperm)
    pc, pct, pT, pTp = pmi.shared_origin_constants(ps.mesh, t(ro), pperm)
    assert (pT, pTp) == (jT, jTp) == (1280, 1280)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pct.numpy(), np.asarray(jct), rtol=1e-6, atol=1e-6)
    jA = jmi.mesh_tri_vertices(js.mesh, (0, 0), jperm)
    pA = pmi.mesh_tri_vertices(ps.mesh, pperm)
    for a, b in zip(pA, jA):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(pmi.tri_attr_matrix(ps.mesh, pperm, 1280).numpy(),
                          np.asarray(jmi.tri_attr_matrix(js.mesh, (0, 0), 1280, jperm)))
    assert np.array_equal(pmi.general_ray_constants(ps.mesh, pperm).numpy(),
                          np.asarray(jmi.general_ray_constants(js.mesh, (0, 0), jperm)[0]))


def _lists_inputs(rng, shadow: bool, n=4096):
    verts, tri_v = soup(rng, 300)
    A, B, C = (verts[tri_v[:, k]] for k in range(3))
    spheres = np.asarray(jmk.chunk_spheres(A, B, C, 300, 512))
    if not shadow:
        d = rng.normal(size=(3, n)).astype(np.float32)
        d[2] = np.abs(d[2]) + 0.5
        d /= np.linalg.norm(d, axis=0)
        o = np.broadcast_to(np.array([[0.0], [0.0], [-6.0]], np.float32), (3, n)).copy()
        return spheres, d, o, None, None
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    valid = rng.uniform(size=n) > 0.3
    valid[:256] = False  # two all-masked sub-cones
    bound = np.where(valid, rng.uniform(0.2, 5.0, n), 0.0).astype(np.float32)
    return spheres, d, o, valid, bound


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_live_chunk_lists_match_jax(shadow):
    """counts and the live set exact; order and minds too where the floors
    agree (a 1-ulp difference of a cone reduction may move a chunk across a
    bucket edge; that stays below 1% of live entries)."""
    spheres, d, o, valid, bound = _lists_inputs(np.random.default_rng(9), shadow)
    jo, jmn, jc = (np.asarray(x) for x in jmk.live_chunk_lists(
        spheres, d, o, valid=None if valid is None else jnp.asarray(valid),
        lane_bound=None if bound is None else jnp.asarray(bound)))
    po, pmn, pc = pmk.live_chunk_lists(
        t(spheres), t(d), t(o), valid=None if valid is None else t(valid),
        lane_bound=None if bound is None else t(bound))
    jo, jmn, jc = jo[:, 0, :], jmn[:, 0, :], jc[:, 0, 0]
    po, pmn, pc = po.numpy(), pmn.numpy(), pc.numpy()
    assert np.array_equal(pc, jc) and jc.sum() > 0
    live = np.arange(jo.shape[1])[None, :] < jc[:, None]
    for b in range(jo.shape[0]):
        assert set(po[b, live[b]]) == set(jo[b, live[b]])
    assert np.mean(po[live] != jo[live]) <= 0.01
    rows = np.arange(jo.shape[0])[:, None]
    np.testing.assert_allclose(pmn[rows, po][live], jmn[rows, jo][live], rtol=1e-6, atol=1e-6)


def test_bucket_order_scatter_inversion_equals_one_hot():
    """The port inverts the counting-sort permutation with scatter_; the JAX
    package with a (B, C, C) one-hot sum. Same mind/overlap -> same lists."""
    rng = np.random.default_rng(10)
    mind = rng.uniform(0.0, 5.0, (24, 40)).astype(np.float32)
    mind[3] = 1.0  # all ties: stable order by chunk id
    overlap = rng.uniform(size=(24, 40)) > 0.4
    overlap[5] = False  # a block with nothing live
    jo, jk, jc = (np.asarray(x) for x in jmk.bucket_order(jnp.asarray(mind),
                                                          jnp.asarray(overlap)))
    po, pk, pc = pmk.bucket_order(t(mind), t(overlap))
    assert np.array_equal(po.numpy(), jo[:, 0, :])
    assert np.array_equal(pc.numpy(), jc[:, 0, 0])
    np.testing.assert_array_equal(pk.numpy(), jk[:, 0, :])


def _general_inputs(rng, T=200, n=3072, cut=0.2):
    """Shadow rays through a soup; the lanes whose uniform draw is at most
    `cut` are masked (tmax = tcut = 0)."""
    jmesh = _soup_mesh(rng, T)
    perm = jnp.arange(T, dtype=jnp.int32)
    cols, _, T_pad = jmi.general_ray_constants(jmesh, (0, T), perm)
    A, B, C = jmi.mesh_tri_vertices(jmesh, (0, T), perm)
    spheres = jmk.chunk_spheres(A, B, C, T, T_pad)
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    mom = np.cross(o.T, d.T).T.astype(np.float32)
    r10 = np.concatenate([d, mom, o, np.ones((1, n), np.float32)]).astype(np.float32)
    tmax = rng.uniform(1.0, 9.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > cut
    tmax = np.where(valid, tmax, 0.0).astype(np.float32)
    tcut = np.where(valid, np.maximum(tmax * 0.999 - 1e-3, 0.0), 0.0).astype(np.float32)
    return np.asarray(cols), np.asarray(spheres), r10, tmax, valid, tcut


def test_general_walk_matches_interpret_kernel_lit_mask():
    cols, spheres, r10, tmax, valid, tcut = _general_inputs(np.random.default_rng(11))
    want = np.asarray(jmk.general_min_t(cols, spheres, r10, jnp.asarray(tmax),
                                        valid=jnp.asarray(valid), tcut_obj=jnp.asarray(tcut),
                                        interpret=True))
    got = pmk.general_min_t(t(cols), t(spheres), t(r10), t(tmax), t(valid), t(tcut)).numpy()
    lit_w, lit_g = want >= tmax, got >= tmax
    assert np.array_equal(lit_g[valid], lit_w[valid])
    assert lit_w[valid].sum() > 50 and (~lit_w[valid]).sum() > 50  # both verdicts occur
    assert np.all(got <= tmax)  # the result is min(hit, tmax)


def test_general_walk_exact_below_tcut_free_lanes():
    """With tcut 0 (no retirement) the walk is an exact bounded min-t."""
    cols, spheres, r10, tmax, valid, _ = _general_inputs(np.random.default_rng(12))
    zero = np.zeros_like(tmax)
    want = np.asarray(jmk.general_min_t(cols, spheres, r10, jnp.asarray(tmax),
                                        valid=jnp.asarray(valid), tcut_obj=jnp.asarray(zero),
                                        interpret=True))
    got = pmk.general_min_t(t(cols), t(spheres), t(r10), t(tmax), t(valid), t(zero)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-6)


def _garbage_in_masked_lanes(r10, tmax, seed):
    """r10 with the rays of the lanes at tmax == 0 replaced by finite seeded
    garbage (not NaN, which torch.minimum would carry into the result)."""
    out = r10.copy()
    masked = tmax == 0.0
    out[:, masked] = np.random.default_rng(seed).uniform(-4.0, 4.0, (10, int(masked.sum())))
    return out


@pytest.mark.parametrize("tier", ["flat", "large_s32"])
def test_general_walk_ignores_the_rays_of_masked_lanes(tier):
    """The fact the shadow-walk kernels rely on, pinned in the twins: with
    about 5% of the lanes at tmax > 0, replacing the rays of the tmax == 0
    lanes by garbage changes no bit of the result (K6's twin through
    general_min_t on 800 triangles; K12's, large_general_walk_plain, through
    large_general_min_t on a 3,000-triangle soup in superchunks of 32), the
    masked lanes return tmax = 0, and the JAX package's interpret kernel on
    the garbage rays agrees with the twin's lit mask."""
    T = 800 if tier == "flat" else 3000
    cols, spheres, r10, tmax, valid, tcut = _general_inputs(np.random.default_rng(14), T=T,
                                                            cut=0.95)
    dirty = _garbage_in_masked_lanes(r10, tmax, 15)
    if tier == "flat":
        def port(r):
            return pmk.general_min_t(t(cols), t(spheres), t(r), t(tmax), t(valid),
                                     t(tcut)).numpy()
    else:
        assert pml._super_s(spheres.shape[0]) == 32
        rows = pmk.general_tri_rows(t(cols))

        def port(r):
            return pml.large_general_min_t(rows, t(spheres), t(r), t(tmax), t(valid), t(tcut),
                                           T).numpy()
    clean, got = port(r10), port(dirty)
    assert 0.03 < valid.mean() < 0.07
    assert np.array_equal(got.view(np.int32), clean.view(np.int32))
    assert np.all(got[~valid] == 0.0)
    lit = got >= tmax
    assert lit[valid].sum() > 10 and (~lit[valid]).sum() > 10  # both verdicts occur
    if tier == "flat":
        want = np.asarray(jmk.general_min_t(cols, spheres, dirty, jnp.asarray(tmax),
                                            valid=jnp.asarray(valid),
                                            tcut_obj=jnp.asarray(tcut), interpret=True))
        assert np.array_equal(lit[valid], (want >= tmax)[valid])


def test_walk_general_lists_counts_the_walked_chunks():
    """walked=True also returns each block's walked chunks, at most its live
    count, none for a block whose lanes are all masked; the result is the
    same."""
    cols, spheres, r10, tmax, valid, tcut = _general_inputs(np.random.default_rng(16))
    valid[:pmk.NB] = False  # block 0: every lane masked
    tmax[:pmk.NB] = tcut[:pmk.NB] = 0.0
    tmax2 = t(np.stack([tmax, tcut]))
    lo, hi = pmk._box_of(t(spheres))
    order, minds, counts = pmk.live_chunk_lists(
        t(spheres), t(r10[0:3]), t(r10[6:9]), valid=t(valid),
        lane_bound=pmk._general_lane_bound(tmax2[0], t(r10), lo, hi))
    args = (torch.cat([lo, hi]), pmk.general_tri_rows(t(cols)), t(r10), tmax2)
    want = pmk.general_walk_plain(order, minds, counts, *args)
    got, walked = pmk.walk_general_lists(order, minds.gather(1, order.long()), counts, *args,
                                         walked=True)
    assert torch.equal(got, want)
    assert walked.tolist()[0] == 0 and int(walked.sum()) > 0
    assert bool((walked <= counts).all())


def test_mesh_min_t_general_matches_jax_jnp_truth(fixture_scenes):
    """Shadow rays from points around the fixture mesh: the port's bounded
    walk agrees with the JAX package's unculled jnp scan on every verdict."""
    (js, jm), (ps, pm) = fixture_scenes
    rng = np.random.default_rng(13)
    n = 2048
    m4, inv_m = np.asarray(js.objects.m[0]), np.asarray(js.objects.inv_m[0])
    o = (m4[:3, 3][:, None] + rng.normal(size=(3, n)) * 1.6).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    tmax = np.where(rng.uniform(size=n) > 0.1, rng.uniform(0.5, 4.0, n), 0.0).astype(np.float32)
    truth = np.asarray(jmi.mesh_min_t_general(
        js.mesh, (0, 0), m4, inv_m, o, d, use_pallas=False,
        perm=jnp.asarray(jm.mesh_perms[0], jnp.int32)))
    got = pmi.mesh_min_t_general(ps.mesh, t(m4), t(inv_m), t(o), t(d),
                                 torch.as_tensor(pm.mesh_perms[0]), ps.mesh_static[0],
                                 t(tmax)).numpy()
    rel = tmax > 0
    assert np.array_equal((got >= tmax)[rel], (truth >= tmax)[rel])
    assert 0.05 < (truth < tmax)[rel].mean() < 0.95


def test_box_bound_keeps_zero_dirs_on_a_box_plane():
    """The 0 * inf slab NaN (mesh_kernels._safe_inv): lanes with an
    exact-zero direction component (+0.0 and -0.0) whose origin lies on
    that axis's lo or hi plane, inside the other two slabs. A plain
    reciprocal makes their slab 0 * inf = NaN; the port's bound is finite,
    the box exit with its margin, as the JAX package's (_general_lane_bound,
    the bound its walks compute in-kernel)."""
    rng = np.random.default_rng(31)
    lo, hi = np.array([-1.0, -1.5, 4.0], np.float32), np.array([1.0, 1.5, 8.0], np.float32)
    o, d = [], []
    for ax in range(3):
        for plane in (lo, hi):
            for zero in (0.0, -0.0):
                p = rng.uniform(lo + 0.1, hi - 0.1).astype(np.float32)
                p[ax] = plane[ax]
                v = rng.normal(size=3).astype(np.float32)
                v[ax] = zero
                o.append(p)
                d.append(v / np.linalg.norm(v))
    o, d = np.stack(o, 1), np.stack(d, 1).astype(np.float32)
    r10 = np.concatenate([d, np.zeros_like(d), o, np.ones_like(d[:1])]).astype(np.float32)
    tmax = np.full(o.shape[1], pmk.INF, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        naive = [(np.array([lo, hi])[:, ax, None] - o[ax]) * (1.0 / d[ax]) for ax in range(3)]
    assert all(np.isnan(x).any(axis=0).sum() == 4 for x in naive)
    want = np.asarray(jmk._general_lane_bound(jnp.asarray(tmax), jnp.asarray(r10),
                                              jnp.asarray(lo), jnp.asarray(hi)))
    got = pmk._general_lane_bound(t(tmax), t(r10), t(lo), t(hi)).numpy()
    # the clamp reads a zero as +1e-12: a lane on a lo plane runs through the
    # box, one on a hi plane leaves it at once (bound 0, no NaN either way)
    on_lo = np.tile([True, True, False, False], 3)
    assert np.isfinite(got).all() and (got[on_lo] > 0).all() and (got[~on_lo] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(pmk._box_bound(t(lo), t(hi), t(o), t(d)).numpy(), got)


def test_shared_walk_keeps_box_plane_lanes():
    """The same case through K5's walk: the shared origin on the union box's
    lo.x plane, block 1's rays with an exact-zero x direction along it.
    Their bound keeps the block walking (a plain reciprocal would stop it
    at once), and the twin matches the interpret kernel on every lane."""
    consts, c_t, spheres, attrs, d, ro = _shared_inputs(np.random.default_rng(32))
    lo = np.asarray(pmk._box_of(t(spheres))[0])
    ro = np.array([lo[0], 0.0, -6.0], np.float32)
    perm = jnp.arange(300, dtype=jnp.int32)
    rng = np.random.default_rng(33)
    jmesh = _soup_mesh(np.random.default_rng(32), 300)
    consts, c_t, _, _ = (np.asarray(x) for x in jmi.shared_origin_constants(
        jmesh, (0, 300), jnp.asarray(ro), perm))
    d[0, pmk.NB:2 * pmk.NB] = 0.0
    d[1:, pmk.NB:2 * pmk.NB] = rng.normal(size=(2, pmk.NB)) * 0.1 + np.array([[0.0], [1.0]])
    d /= np.linalg.norm(d, axis=0)
    assert (d[0, pmk.NB:2 * pmk.NB] == 0.0).all()
    _compare_shared(consts, c_t, spheres, attrs, d, ro)
    dh_p, sph = t(d), t(spheres)
    order, minds, counts = pmk.live_chunk_lists(sph, dh_p, t(ro)[:, None].expand_as(dh_p))
    args = (torch.cat([t(lo), pmk._box_of(sph)[1], t(ro)]), pmk.shared_tri_rows(t(consts), t(c_t)),
            t(attrs), dh_p)
    *_, walked = pmk.walk_shared_lists(order, minds.gather(1, order.long()), counts, *args,
                                       walked=True)
    assert int(walked[1]) > 0


def test_tail_triangles_past_the_last_whole_512_are_hit():
    """The jnp tail-chunk drop (the JAX package's mesh_intersect_shared
    scans chunks of gcd(tri_chunk, T_pad) triangles, since a floor-divided
    count of 512-triangle chunks skipped triangles 512-767 of T_pad = 768):
    T = 700 pads to 768, and rays aimed at triangles 512-699 hit them through
    the port's walk (24 whole chunks of 32) as through the JAX package's jnp
    scan at tri_chunk 512, with the same hit mask and t."""
    rng = np.random.default_rng(34)
    T, n = 700, 2048
    verts, tri_v = soup(rng, T)
    verts = verts + np.array([0.0, 0.0, 6.0], np.float32)
    jmesh = _soup_mesh(rng, T, (verts, tri_v))
    ro = np.zeros(3, np.float32)
    d = aim_at(rng, verts, tri_v, rng.integers(512, T, n), ro)
    eye = jnp.eye(4, dtype=jnp.float32)
    perm = jnp.arange(T, dtype=jnp.int32)
    jt, _, _, jvalid = (np.asarray(x) for x in jmi.mesh_intersect_shared(
        jmesh, (0, T), eye, eye, jnp.asarray(ro), jnp.asarray(d), tri_chunk=512,
        use_pallas=False, perm=perm))
    consts, c_t, _, T_pad = jmi.shared_origin_constants(jmesh, (0, T), jnp.asarray(ro), perm)
    assert T_pad == 768 and T_pad % 512 != 0
    spheres = np.asarray(jmk.chunk_spheres(*jmi.mesh_tri_vertices(jmesh, (0, T), perm), T, T_pad))
    attrs = np.zeros((T_pad, 15), np.float32)
    pt_, _, _, ptri, _ = (x.numpy() for x in pmk.shared_nearest_hit(
        t(np.asarray(consts)), t(np.asarray(c_t)), t(attrs), t(spheres), t(d), t(ro)))
    assert jvalid.all() and np.array_equal(ptri >= 0, jvalid)
    assert (ptri >= 512).mean() > 0.5
    np.testing.assert_allclose(pt_, jt, rtol=1e-5)
