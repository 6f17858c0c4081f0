"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: each test asks the `cuda` fixture for the device and skips
where there is none, so this file passes nothing on a CPU-only host. It
imports no JAX. On a machine with an NVIDIA GPU (and no JAX) run it with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Kernel and twin run the same fp32 operations in the same order (the kernels
are built with -fmad=false), so they agree to the last bit except where a
library function differs (atan2/asin in the spherical UVs); the six mesh
walks K5, K6, K9, K10, K11 and K12 are held to that, ties included.
"""

import collections

import numpy as np
import pytest
import torch
from torch_port_fixtures import aim_at, repeat_for_ties, soup

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fixture_scene(cuda, tmp_path_factory):
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    host = pt.load_scene_file(write_demo_scene(str(tmp_path_factory.mktemp("fx")), 3))
    return host, pt.build_scene(host, device=cuda)


def _launches(name):
    from relativitypathtracer_tpu_torch.ops.kernels import _build

    return _build.LAUNCHES[name]


# Shadow lanes by activity pattern (tmax > 0), for n lanes in blocks of 1024.
ACTIVITY = {
    "scattered": lambda rng, n: rng.uniform(size=n) < 0.05,
    "one_per_block": lambda rng, n: np.isin(np.arange(n), np.arange(0, n, 1024)
                                            + rng.integers(0, 1024, n // 1024)),
    "all_masked": lambda rng, n: np.zeros(n, bool),
    "all_active": lambda rng, n: np.ones(n, bool),
}


# Primary rays by coverage pattern, from (0, 0, -6) at a column of soup:
# soup() narrowed to |x|, |y| <= 0.575 (z in [-2.3, 2.3]) with its triangles
# sorted by depth, so chunk c is the c-th slab from the camera. "all_hit":
# each ray aimed at a point of a triangle of the front third, so the walks
# stop early; "silhouette": the upper half of every block aimed past the
# column (x = 0.6-0.75 at its front) but through its union box, so those
# lanes miss the mesh with a bound above 0; "all_miss": every ray
# looking away from the union box; "ties": each ray aimed at a repeated
# triangle (the column with repeat_for_ties); "box_plane": the camera on the
# union box's lo.x plane, the lower half of every block aimed at the front
# third, the upper half with an exact-zero x direction, along that plane
# (the 0 * inf slab case of mesh_kernels._safe_inv).
COVERAGE = ("all_hit", "silhouette", "all_miss", "ties", "box_plane")


def _column_soup(rng, T, pattern):
    """(vertices, tri_v, ties): the column of soup, and for "ties" with its
    repeats ((inside, across) of repeat_for_ties, else None)."""
    verts, tri_v = soup(rng, T)
    verts = verts * np.array([0.25, 0.25, 1.0], np.float32)
    tri_v = tri_v[np.argsort(verts[tri_v].mean(axis=1)[:, 2], kind="stable")]
    return verts, tri_v, repeat_for_ties(tri_v) if pattern == "ties" else None


def _primary_dirs(rng, verts, tri_v, T, n, pattern, ties=None, ro=(0.0, 0.0, -6.0)):
    aim = rng.choice(np.concatenate(ties), n) if pattern == "ties" else rng.integers(0, T // 3, n)
    d = aim_at(rng, verts, tri_v, aim, np.asarray(ro))
    if pattern == "box_plane":
        off = np.arange(n) % 1024 >= 512
        p = np.stack([np.zeros(int(off.sum())), rng.normal(size=int(off.sum())) * 0.05,
                      np.ones(int(off.sum()))])
        d[:, off] = p / np.linalg.norm(p, axis=0)
    if pattern == "silhouette":
        off = np.arange(n) % 1024 >= 512
        m = int(off.sum())
        slope = rng.uniform(0.165, 0.2, m) * rng.choice([-1.0, 1.0], m)
        p = np.stack([slope, np.zeros(m), np.ones(m)])
        d[:, off] = p / np.linalg.norm(p, axis=0)
    if pattern == "all_miss":
        d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n), -np.ones(n)])
        d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return d


def _soup_lists(dev, shadow: bool, T=600, n=8192, seed=0, large=False, pattern=None):
    """K5 (K11 when large) or K6 (K12) walk arguments for a random soup; the
    large tier's lists come from its own list function and the walk also takes
    (S, C, T). A shadow `pattern` of ACTIVITY picks the lanes with tmax > 0
    ("all_active": tmax = INF and tcut = 0) and fills the other lanes' rays
    with finite garbage; a primary `pattern` of COVERAGE aims the rays (the
    tie soup for "ties")."""
    from relativitypathtracer_tpu_torch.models.scene import MeshArrays
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as mi
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    rng = np.random.default_rng(seed)
    if pattern in COVERAGE:
        verts, tri_v, ties = _column_soup(rng, T, pattern)
    else:
        verts, tri_v = soup(rng, T)
    mesh = MeshArrays(torch.as_tensor(verts, device=dev), torch.as_tensor(tri_v, device=dev),
                      *([None] * 11))
    perm = torch.arange(T, device=dev)
    T_pad = mi.padded_tri_count(T)
    A, B, C = mi.mesh_tri_vertices(mesh, perm)
    spheres = mk.chunk_spheres(A, B, C, T_pad)
    build = ml.large_live_lists if large else mk.live_chunk_lists
    tail = (ml._super_s(spheres.shape[0]), spheres.shape[0], T) if large else ()
    d = torch.as_tensor(rng.normal(size=(3, n)), dtype=torch.float32, device=dev)
    if not shadow:
        d[2] = d[2].abs() + 0.5
        d = d / d.norm(dim=0)
        ro = torch.tensor([0.0, 0.0, -6.0], device=dev)
        if pattern == "box_plane":
            ro[0] = mk._box_of(spheres)[0][0]
        if pattern is not None:
            d = torch.as_tensor(_primary_dirs(rng, verts, tri_v, T, n, pattern, ties,
                                              ro.cpu().numpy()), device=dev)
        consts, c_t, _, _ = mi.shared_origin_constants(mesh, ro, perm)
        lists = build(spheres, d, ro[:, None].expand(3, n))
        lo, hi = mk._box_of(spheres)
        attrs = torch.as_tensor(rng.normal(size=(T_pad, 15)), dtype=torch.float32, device=dev)
        return (*lists, torch.cat([lo, hi, ro]), mk.shared_tri_rows(consts, c_t), attrs,
                d.contiguous(), *tail)
    d = d / d.norm(dim=0)
    o = torch.as_tensor(rng.uniform(-3, 3, (3, n)), dtype=torch.float32, device=dev)
    r10 = torch.cat([d, torch.linalg.cross(o, d, dim=0), o, torch.ones_like(d[:1])]).contiguous()
    valid = torch.as_tensor(rng.uniform(size=n) > 0.2, device=dev)
    drawn = torch.as_tensor(rng.uniform(1, 9, n), dtype=torch.float32, device=dev)
    if pattern is not None:
        valid = torch.as_tensor(ACTIVITY[pattern](rng, n), device=dev)
    tmax = torch.where(valid, drawn, 0.0)
    tcut = torch.where(valid, torch.clamp(tmax * 0.999 - 1e-3, min=0.0), 0.0)
    if pattern is not None:
        if pattern == "all_active":
            tmax, tcut = torch.full_like(tmax, 1e20), torch.zeros_like(tcut)
        garbage = torch.as_tensor(rng.uniform(-4, 4, (10, n)), dtype=torch.float32, device=dev)
        r10 = torch.where(valid, r10, garbage).contiguous()
    tmax2 = torch.stack([tmax, tcut]).contiguous()
    lo, hi = mk._box_of(spheres)
    lists = build(spheres, r10[0:3], r10[6:9], valid=valid,
                  lane_bound=mk._general_lane_bound(tmax, r10, lo, hi))
    cols = mi.general_ray_constants(mesh, perm)
    return (*lists, torch.cat([lo, hi]), mk.general_tri_rows(cols), r10, tmax2, *tail)


def test_shared_walk_kernel_matches_twin(cuda):
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    args = _soup_lists(cuda, shadow=False)
    before = _launches("rpt_shared_walk")
    gt, gu, gv, gtri, gattr = mk.shared_walk(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_shared_walk") == before + 1
    want = mk.shared_walk_plain(*args)
    assert bool((want[3] >= 0).any())
    for g, w in zip((gt, gu, gv, gtri, gattr), want):
        assert torch.equal(g, w)


def test_general_walk_kernel_matches_twin(cuda):
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    args = _soup_lists(cuda, shadow=True)
    got = mk.general_walk(*args)
    want = mk.general_walk_plain(*args)
    assert torch.equal(got, want)
    tmax = args[6][0]
    rel = tmax > 0
    assert torch.equal((got >= tmax)[rel], (want >= tmax)[rel])
    assert bool((got <= tmax).all())
    assert int((want < tmax)[rel].sum()) > 50 and int((want >= tmax)[rel].sum()) > 50


def _analytic_scene(dev, rng, case, G, general):
    """Objects for the K3/K7 card cases, packed for K3 (camera at the origin)
    or K7 (general): `mixed` and the others at z 3..7, boosted up to 0.2c;
    `all_culled` behind the camera and the shadow rays (z -14..-9);
    `all_live` around the camera (the
    camera inside every bounding ball); `many` as cubes.txt: 34 cubes in two
    rows and a light sphere, half of the cubes at 0.9c."""
    from relativitypathtracer_tpu_torch.ops import relmath
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak

    if case == "many":
        pos = np.stack([np.r_[0.0, np.tile(np.linspace(-4, 4, 17), 2)],
                        np.r_[3.0, np.repeat([-0.5, 0.8], 17)],
                        np.r_[6.0, np.repeat([5.0, 8.0], 17)]], 1)
        scale = np.full((G, 3), 0.2)
        vel = np.zeros((G, 3))
        vel[18:, 0] = 0.9
    else:
        z = {"all_culled": (-14, -9), "all_live": (-0.3, 0.3)}.get(case, (3, 7))
        pos = np.stack([rng.uniform(-2, 2, G), rng.uniform(-1.5, 1.5, G), rng.uniform(*z, G)], 1)
        if case == "all_live":
            pos[:, :2] *= 0.1
        scale = rng.uniform(0.5, 1.2, (G, 3)) * (8.0 if case == "all_live" else 1.0)
        vel = rng.normal(size=(G, 3)) * 0.2
    m = torch.stack([relmath.trs(p.astype(np.float32), np.float32(rng.uniform(0, 3)),
                                 rng.normal(size=3).astype(np.float32),
                                 s.astype(np.float32)) for p, s in zip(pos, scale)])
    L = relmath.lorentz(torch.as_tensor(vel, dtype=torch.float32)).to(dev)
    inv_m = relmath.inverse4(m).to(dev)
    if general:
        return ak.pack_analytic_params_general(L, inv_m, tuple(range(G)))
    return ak.pack_analytic_params(L, inv_m, torch.zeros((G, 4), device=dev), tuple(range(G)))


# K3's card cases: objects (spheres, cubes) and rays
K3_CASES = {"one_sphere": (1, 0), "mixed": (6, 5), "all_culled": (3, 4), "all_live": (3, 4),
            "grazing": None, "ragged": (2, 3), "many": (1, 34)}


def _k3_inputs(dev, case):
    """[(params, dir4, n_spheres, n_cubes)] of a K3 card case; `grazing` is
    every case of the CPU pre-test's adversarial rays, in the K3 form."""
    from torch_port_fixtures import PRETEST_CASES, pretest_inputs

    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "grazing":
        return [(p.to(dev), d.to(dev), ns, nc) for p, d, _, ns, nc in
                (pretest_inputs(rng, "K3", c) for c in PRETEST_CASES)]
    ns, nc = K3_CASES[case]
    params = _analytic_scene(dev, rng, case, ns + nc, general=False)
    n = 65536 - 13 if case == "ragged" else 65536
    d = torch.as_tensor(rng.normal(size=(3, n)) * 0.35, dtype=torch.float32, device=dev)
    d[2] = 1.0
    dir4 = torch.cat([torch.full((1, n), -1.0, device=dev), d / d.norm(dim=0)]).contiguous()
    return [(params, dir4, ns, nc)]


@pytest.mark.parametrize("case", list(K3_CASES))
def test_analytic_kernel_matches_twin(cuda, case):
    """K3 against its twin: t, normal and object id equal to the bit, uv
    within 1e-5 (CUDA's atan2f/asinf against PyTorch's); one launch a
    call; its `tested` counter equal to the (warp, object) pairs that the
    pre-test's plain form lets through (none for `all_culled`, every pair
    for `all_live`)."""
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak

    for params, dir4, n_spheres, n_cubes in _k3_inputs(cuda, case):
        tested = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = _launches("rpt_analytic_nearest")
        gt, gn, guv, go = ak.analytic_nearest_shared(params, dir4, n_spheres, n_cubes,
                                                     tested=tested)
        torch.cuda.synchronize()
        assert _launches("rpt_analytic_nearest") == before + 1
        wt, wn, wuv, wo = ak.analytic_nearest_plain(params, dir4, n_spheres, n_cubes)
        hit = wt < 1e19
        assert bool(hit.any()) == (case != "all_culled") and torch.equal(gt < 1e19, hit)
        assert float((go != wo).float().mean()) <= 1e-3
        same = hit & (go == wo)
        torch.testing.assert_close(gt[same], wt[same], rtol=1e-5, atol=0)
        torch.testing.assert_close(gn[:, same], wn[:, same], rtol=0, atol=1e-5)
        torch.testing.assert_close(guv[:, same], wuv[:, same], rtol=0, atol=1e-5)
        # With its sphere and cube tests in __device__ functions shared with
        # K7, K3 still runs its twin's fp32 operations in the same order,
        # and the objects its vote skips leave every lane as it was.
        assert torch.equal(gt, wt) and torch.equal(gn, wn) and torch.equal(go, wo)
        may = ak.object_may_hit_plain(params, dir4, n_spheres, n_cubes)
        want = ak.warp_votes_plain(may)
        assert int(tested) == want, (int(tested), want)
        pairs = may.shape[0] * -(-dir4.shape[1] // ak.WARP)
        if case == "all_culled":
            assert want == 0
        if case == "all_live":
            assert want == pairs


def test_shadow_chain_kernel_matches_twin(cuda):
    from relativitypathtracer_tpu_torch.ops import relmath
    from relativitypathtracer_tpu_torch.ops.kernels import shadow_chain as sc

    rng = np.random.default_rng(3)
    O, n, light = 3, 65536, 2
    vel = torch.as_tensor(rng.normal(size=(O, 3)) * 0.25, dtype=torch.float32)
    vel[light] = 0.0
    L, inv_L = relmath.lorentz(vel), relmath.lorentz(-vel)
    stat = relmath.transform4(L, torch.tensor([[0.3, 0.1, 0.0, 0.2]]))
    mats = sc.pack_chain_mats(L, inv_L, stat).to(cuda)
    row = sc.pack_light_row(L[light], inv_L[light], torch.tensor([0.5, 2.0, 4.0])).to(cuda)
    d = torch.as_tensor(rng.normal(size=(3, n)) * 0.4, dtype=torch.float32)
    d[2] = 1.0
    dir4 = torch.cat([torch.full((1, n), -1.0), d / d.norm(dim=0)]).to(cuda)
    t = torch.as_tensor(rng.uniform(2, 8, n), dtype=torch.float32)
    t[torch.as_tensor(rng.uniform(size=n) < 0.2)] = 1e20
    nrm = torch.as_tensor(rng.normal(size=(3, n)), dtype=torch.float32)
    nrm = (nrm / nrm.norm(dim=0)).to(cuda)
    obj = torch.as_tensor(rng.integers(0, O, n), dtype=torch.int32).to(cuda)
    args = (mats, row, dir4, t.to(cuda), nrm, obj, -1)
    got, want = sc.shadow_chain(*args), sc.shadow_chain_plain(*args)
    rel = (args[3] < 1e20) & (obj != light) & (want[2] > 0)
    assert int(rel.sum()) > n // 4
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., rel], w[..., rel], rtol=1e-5, atol=1e-6)


def test_card_frame_matches_cpu_frame(cuda, fixture_scene):
    """The fixture at 256x192, moving camera: the card's frame (the four
    kernels) against the port's CPU frame (their twins), parity rule."""
    import relativitypathtracer_tpu_torch as pt

    host, (scene, meta) = fixture_scene
    state = ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0))
    card = pt.build_render_fn(meta, 256, 192, -1, with_aux=True, device=cuda)
    img, aux = card(scene, pt.FrameState(torch.tensor(state[0], device=cuda),
                                         torch.tensor(state[1], device=cuda)))
    cpu_scene, cpu_meta = pt.build_scene(host, device="cpu")
    ref, ref_aux = pt.build_render_fn(cpu_meta, 256, 192, -1, with_aux=True, device="cpu")(
        cpu_scene, pt.FrameState(torch.tensor(state[0]), torch.tensor(state[1])))
    diff = (img.cpu() - ref).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) <= 0.002
    assert int(aux["hits"]) > 0 and int(aux["shadow_rays"]) > 0


@pytest.mark.parametrize("w,h", [(32, 48), (256, 256), (1024, 640)],
                         ids=["small_K2", "mid_K8", "big"])
def test_footprint_kernel_matches_twin(cuda, w, h):
    """K2/K8 on one region per atlas tier, the renderer's per-object form
    (three objects, one untextured): the same atlas quad on every lane, RGB
    to the bit; the launch counts under the atlas's route."""
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as tk
    from relativitypathtracer_tpu_torch.ops.texture_layout import region_quads, texture_table

    rng = np.random.default_rng(w + h)
    wb = -(-w // 16)
    rows = int(region_quads(np.int64(wb), np.int64(h))) * 4 // 8
    quads = torch.as_tensor(rng.integers(0, 2 ** 24, (rows, 8)), dtype=torch.int32, device=cuda)
    fp = torch.tensor([[0, 0, 0, wb, w, h], [0, 0, 0, 0, 0, 0], [0, 3, 2, wb, w - 5, h - 4]],
                      dtype=torch.int32, device=cuda)
    table = texture_table(torch.tensor([w, 0, w], dtype=torch.int32, device=cuda),
                          torch.tensor([h, 0, h], dtype=torch.int32, device=cuda), fp)
    n = 200_000
    obj = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32, device=cuda)
    uv = torch.as_tensor(rng.random((2, n)), dtype=torch.float32, device=cuda)
    uv[0, :500], uv[1, 500:1000], uv[:, 1000:1100] = 1.0, 0.0, 0.0
    key = "rpt_footprint_sample/" + tk.texture_route(rows)
    before = _launches(key)
    got, gq = tk.footprint_fetch(quads, table, obj, uv, with_quads=True)
    torch.cuda.synchronize()
    assert _launches(key) == before + 1
    want, wq = tk.footprint_fetch_plain(quads, table, obj, uv)
    assert torch.equal(gq, wq)
    assert torch.equal(got, want)
    per_lane = tk.footprint_sample_small(quads, table[obj.long(), 2:].T.contiguous(),
                                         table[obj.long(), 0], table[obj.long(), 1], uv)
    assert torch.equal(per_lane, got)


FETCH_TIERS = {"small_K2": (32, 48), "mid_K8": (256, 256), "big": (1024, 640)}
FETCH_N = (1, 3, 4, 1027, 200_003, 786_432)


def _fetch_inputs(dev, w, h, n, cols=None):
    """A random w x h footprint atlas, four objects on it (the second
    untextured, as the renderer's scenes have them) with flat colours and
    flags, and n lanes: (quads, table, color, textured, obj, uv), uv with
    `cols` columns (default n), lanes at the clamp edges among them."""
    from relativitypathtracer_tpu_torch.ops.texture_layout import region_quads, texture_table

    rng = np.random.default_rng(w * 7 + n)
    wb = -(-w // 16)
    rows = int(region_quads(np.int64(wb), np.int64(h))) * 4 // 8
    quads = torch.as_tensor(rng.integers(0, 2 ** 24, (rows, 8)), dtype=torch.int32, device=dev)
    fp = torch.tensor([[0, 0, 0, wb, w, h], [0, 0, 0, 0, 0, 0], [0, 3, 2, wb, w - 5, h - 4],
                       [0, w // 2, 0, wb, w - w // 2, h]], dtype=torch.int32, device=dev)
    table = texture_table(torch.tensor([w, 0, w, w], dtype=torch.int32, device=dev),
                          torch.tensor([h, 0, h, h], dtype=torch.int32, device=dev), fp)
    color = torch.as_tensor(rng.random((4, 3)), dtype=torch.float32, device=dev)
    textured = torch.tensor([True, False, True, True], device=dev)
    obj = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32, device=dev)
    uv = torch.as_tensor(rng.random((2, cols or n)), dtype=torch.float32, device=dev)
    uv[0, : n // 8], uv[1, n // 8: n // 4], uv[:, n // 4: n // 4 + 3] = 1.0, 0.0, 0.0
    return quads, table, color, textured, obj, uv


def _fetch_bit_for_bit(quads, table, color, textured, obj, uv, select):
    """The kernel against its twin: RGB and quads to the bit, one launch
    counted under the atlas's route, untextured lanes their flat colour."""
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as tk

    extra = (color, textured) if select else ()
    key = "rpt_footprint_sample/" + tk.texture_route(quads.shape[0])
    before = _launches(key)
    got, gq = tk.footprint_fetch(quads, table, obj, uv, *extra, with_quads=True)
    torch.cuda.synchronize()
    assert _launches(key) == before + 1
    want, wq = tk.footprint_fetch_plain(quads, table, obj, uv, *extra)
    assert torch.equal(gq, wq)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tk.footprint_fetch(quads, table, obj, uv, *extra), got)
    flat = ~textured[obj.long()]
    if select and bool(flat.any()):
        assert torch.equal(got[:, flat], color.T[:, obj.long()[flat]])


@pytest.mark.parametrize("select", [False, True], ids=["texel", "select"])
@pytest.mark.parametrize("n", FETCH_N)
@pytest.mark.parametrize("tier", list(FETCH_TIERS))
def test_footprint_kernel_bit_for_bit(cuda, tier, n, select):
    """K2/K8 at ragged and full-frame N on each atlas tier, with and without
    the flat-colour select: equal to the twin to the bit, quads included
    (N = 1, 3, 4 and 1,027 end inside a CTA, 786,432 fills 3,072 of them,
    200,003 ends in a part-filled one)."""
    w, h = FETCH_TIERS[tier]
    _fetch_bit_for_bit(*_fetch_inputs(cuda, w, h, n), select)


@pytest.mark.parametrize("select", [False, True], ids=["texel", "select"])
@pytest.mark.parametrize("n", (1027, 786_432))
@pytest.mark.parametrize("tier", list(FETCH_TIERS))
def test_footprint_kernel_misaligned_uv(cuda, tier, n, select):
    """uv a column slice of a wider (2, N + 5) tensor, read in place through
    its row stride, its rows 4 bytes past a 16-byte boundary: equal to the
    twin to the bit."""
    w, h = FETCH_TIERS[tier]
    quads, table, color, textured, obj, wide = _fetch_inputs(cuda, w, h, n, cols=n + 5)
    uv = wide[:, 1:n + 1]
    assert uv.data_ptr() % 16 and not uv.is_contiguous()
    _fetch_bit_for_bit(quads, table, color, textured, obj, uv, select)


def test_cuda_scalar_division_is_not_exact(cuda):
    """Why the twin reads its channel values from a table: on the card,
    PyTorch's true division by a Python scalar multiplies by the reciprocal,
    which misses float32 k / 255 for some k; a division by a tensor and the
    table do not."""
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as tk

    k = torch.arange(256, dtype=torch.float32, device=cuda)
    want = torch.as_tensor(tk.CHANNEL, device=cuda)
    by_scalar = int((k / 255.0 != want).sum())
    by_tensor = int((k / torch.full_like(k, 255.0) != want).sum())
    print(f"k / 255.0 off on {by_scalar} of 256 values; k / tensor on {by_tensor}")
    assert by_tensor == 0


K7_CASES = ("mixed", "all_culled", "all_live", "grazing", "ragged", "many", "masked_garbage")


def _k7_inputs(dev, case):
    """[(params, origins4, dir4, n_spheres, n_cubes, tmax)] of a K7 card
    case: shadow rays from x 0..9 (time), y +-0.5, z +-2.5 towards +z;
    tmax 1..12, 0 on a fifth of the lanes; `masked_garbage` puts NaN,
    infinite and huge origins and directions on the masked lanes;
    `grazing` is every case of the CPU pre-test's adversarial rays, in the
    K7 form, with tmax 1."""
    from torch_port_fixtures import PRETEST_CASES, pretest_inputs

    rng = np.random.default_rng(71 + sum(map(ord, case)))
    if case == "grazing":
        return [(p.to(dev), o.to(dev), d.to(dev), ns, nc, torch.ones(d.shape[1], device=dev))
                for p, d, o, ns, nc in (pretest_inputs(rng, "K7", c) for c in PRETEST_CASES)]
    ns, nc = (1, 34) if case == "many" else (2, 9)
    params = _analytic_scene(dev, rng, case, ns + nc, general=True)
    n = 131072 - 29 if case == "ragged" else 131072
    o = torch.as_tensor(np.stack([rng.uniform(0, 9, n), rng.uniform(-0.5, 0.5, n),
                                  rng.uniform(-2.5, 2.5, n), rng.uniform(-2.5, 2.5, n)]),
                        dtype=torch.float32, device=dev)
    d = torch.as_tensor(rng.normal(size=(3, n)) * 0.4, dtype=torch.float32, device=dev)
    d[2] = 1.0
    dir4 = torch.cat([torch.full((1, n), -1.0, device=dev), d / d.norm(dim=0)]).contiguous()
    tmax = torch.as_tensor(rng.uniform(1, 12, n), dtype=torch.float32, device=dev)
    masked = torch.as_tensor(rng.uniform(size=n) < 0.2, device=dev)
    tmax[masked] = 0.0
    if case == "masked_garbage":
        junk = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30], device=dev)
        pick = torch.as_tensor(rng.integers(0, 4, (2, 4, n)), device=dev)
        o = torch.where(masked, junk[pick[0]], o)
        dir4 = torch.where(masked, junk[pick[1]], dir4)
    return [(params, o.contiguous(), dir4.contiguous(), ns, nc, tmax)]


@pytest.mark.parametrize("case", K7_CASES)
def test_analytic_min_t_kernel_matches_twin(cuda, case):
    """K7 against its twin: every lane equal to the bit (INF on masked
    lanes, whatever their origins and directions hold), identical lit
    masks on the lanes with tmax > 0; one launch a call; its `tested`
    counter equal to the (warp, object) pairs that the pre-test's plain
    form lets through on the lanes with tmax != 0."""
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak

    for params, o, dir4, ns, nc, tmax in _k7_inputs(cuda, case):
        tested = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = _launches("rpt_analytic_min_t")
        got = ak.analytic_min_t_general(params, o, dir4, ns, nc, tmax, tested=tested)
        torch.cuda.synchronize()
        assert _launches("rpt_analytic_min_t") == before + 1
        want = ak.analytic_min_t_plain(params, o, dir4, ns, nc, tmax)
        rel = tmax > 0
        assert torch.equal((got >= tmax)[rel], (want >= tmax)[rel])
        occ = rel & (want < tmax)
        if case in ("mixed", "ragged", "many", "masked_garbage", "all_live"):
            assert int(occ.sum()) > 1000
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool((got[~rel] == 1e20).all())
        may = ak.object_may_hit_plain(params, dir4, ns, nc, o) & (tmax != 0)
        want_tested = ak.warp_votes_plain(may)
        assert int(tested) == want_tested, (int(tested), want_tested)
        if case == "all_culled":
            assert want_tested == 0


@pytest.mark.parametrize("kind", ["textured", "cubes"])
def test_textured_card_frames_match_cpu_frames(cuda, tmp_path, kind):
    """The textured (K2) and cubes (K7, K8) fixtures at 256x192, moving
    camera: the card's frame against the port's CPU frame, parity rule, and
    msaa 2 on the textured one."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    host = pt.load_scene_file(write_demo_scene(str(tmp_path), 3, kind))
    state = ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0))
    for msaa in (1, 2) if kind == "textured" else (1,):
        scene, meta = pt.build_scene(host, device=cuda)
        img, aux = pt.build_render_fn(meta, 256, 192, -1, msaa, with_aux=True, device=cuda)(
            scene, pt.FrameState(torch.tensor(state[0], device=cuda),
                                 torch.tensor(state[1], device=cuda)))
        cpu_scene, cpu_meta = pt.build_scene(host, device="cpu")
        ref, ref_aux = pt.build_render_fn(cpu_meta, 256, 192, -1, msaa, with_aux=True,
                                          device="cpu")(
            cpu_scene, pt.FrameState(torch.tensor(state[0]), torch.tensor(state[1])))
        diff = (img.cpu() - ref).abs().amax(dim=-1)
        assert float((diff > 1e-3).float().mean()) <= 0.002
        assert int(aux["hits"]) == int(ref_aux["hits"]) > 0


def test_wrapper_checks_dtype_and_shape(cuda):
    from relativitypathtracer_tpu_torch.ops.kernels import shadow_chain as sc

    n = 64
    args = [torch.zeros((40, 2), device=cuda), torch.zeros((1, 36), device=cuda),
            torch.zeros((4, n), device=cuda), torch.zeros(n, device=cuda),
            torch.zeros((3, n), device=cuda), torch.zeros(n, dtype=torch.int64, device=cuda), -1]
    with pytest.raises(TypeError):
        sc.shadow_chain(*args)
    args[5] = torch.zeros(n, dtype=torch.int32, device=cuda)
    args[1] = torch.zeros((1, 35), device=cuda)
    with pytest.raises(ValueError):
        sc.shadow_chain(*args)


def _batch_scene(dev, O, shadow, T, rng, kind=None):
    """O random soups in front of the camera, each with its own rotation,
    non-uniform scale and velocity (K9's objects carry their object-space
    camera origin ro); for K10 object 1 is disabled, as the light's own mesh
    is. kind "ties": every soup with the repeats of repeat_for_ties, and
    object 1 a copy of object 0 (same soup, frame and motion: a tie across
    objects on every hit there); kind "alternating": two copies of the
    depth-sorted column of _column_soup (256 triangles: 8 chunks of 0.575
    in depth), the second half a chunk deeper in the same frame, so the
    lists alternate objects chunk by chunk, none disabled; kind "sparse":
    each soup's triangles shrunk 50x about their first vertex, so most rays
    pass through every object and the walks run long. Returns a dict of the
    walks' per-object arguments."""
    from relativitypathtracer_tpu_torch.models.scene import MeshArrays
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as mi
    from relativitypathtracer_tpu_torch.ops import relmath
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    f32 = np.float32
    cam = torch.tensor([0.3, 0.1, -0.1, 0.0], device=dev)
    out = {k: [] for k in ("rows", "attrs", "spheres", "boxes", "mats", "counts", "ros")}
    for g in range(O):
        if kind == "alternating":
            if g == 0:
                verts, tri_v, _ = _column_soup(rng, T, None)
                eye = torch.eye(4, device=dev)
                m = relmath.trs(np.array([0.1, 0.0, 8.0], f32), f32(0.0), np.array([0, 0, 1], f32),
                                np.array([1.0, 1.2, 1.0], f32)).to(dev)
                frame = (eye, relmath.inverse4(m), m)
            else:
                verts = verts + np.array([0.0, 0.0, 0.2875], f32)
            L, inv_m, m = frame
            vscale = 1.0
        elif kind == "ties" and g == 1:
            L, inv_m, m = frame
        else:
            verts, tri_v = soup(rng, T)
            if kind == "ties":
                repeat_for_ties(tri_v)
            if kind == "sparse":
                first = np.tile(verts[:T], (2, 1))
                verts[T:] = first + (verts[T:] - first) * 0.02
            z = rng.uniform(6.0, 10.0)
            m = relmath.trs(np.array([rng.uniform(-0.1, 0.1) * z, rng.uniform(-0.08, 0.08) * z, z],
                                     f32), f32(rng.uniform(0, 3)), rng.normal(size=3).astype(f32),
                            rng.uniform(0.6, 1.4, 3).astype(f32)).to(dev)
            inv_m = relmath.inverse4(m)
            L = relmath.lorentz(torch.as_tensor(rng.normal(size=3) * 0.05,
                                                dtype=torch.float32)).to(dev)
            frame, vscale = (L, inv_m, m), 0.5
        mesh = MeshArrays(torch.as_tensor(verts * vscale, device=dev),
                          torch.as_tensor(tri_v, device=dev), *([None] * 11))
        perm = torch.arange(T, device=dev)
        T_pad = mi.padded_tri_count(T)
        sph = mk.chunk_spheres(*mi.mesh_tri_vertices(mesh, perm), T_pad)
        lo, hi = mk._box_of(sph)
        if shadow:
            out["rows"].append(mk.general_tri_rows(mi.general_ray_constants(mesh, perm)))
            out["mats"].append(mb.mat_row(L, inv_m, m))
            out["boxes"].append(torch.cat([lo, hi]) if g != 1 or kind == "alternating" else
                                torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], device=dev))
        else:
            ro = inv_m[:3, :3] @ (L @ cam)[1:4] + inv_m[:3, 3]
            consts, c_t, _, _ = mi.shared_origin_constants(mesh, ro, perm)
            out["rows"].append(mk.shared_tri_rows(consts, c_t))
            out["attrs"].append(torch.as_tensor(rng.normal(size=(T_pad, 15)),
                                                dtype=torch.float32, device=dev))
            out["mats"].append(mb.mat_row(L, inv_m, m, ro))
            out["boxes"].append(torch.cat([lo, hi, ro]))
            out["ros"].append(ro)
        out["spheres"].append(sph)
        out["counts"].append(T_pad // mk.TC)
    out["enabled"] = tuple(g != 1 or kind == "alternating" for g in range(O))
    out["cobj"] = mb.chunk_objects(out["counts"], dev)
    return out


def _shared_args(sc, dir4):
    """K9 walk arguments of the objects `sc` (_batch_scene) for camera
    4-dirs dir4, with their live lists."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    mats, spheres = torch.stack(sc["mats"]), torch.cat(sc["spheres"])
    d_os, s_os = mb.object_dirs(mats, dir4)
    o_os = torch.stack(sc["ros"])[:, :, None].expand(len(mats), 3, dir4.shape[1])
    lists = mb.live_chunk_lists_multi(spheres, sc["counts"], d_os, o_os, s_os)
    return (*lists, sc["cobj"], torch.stack(sc["boxes"]), mats, torch.cat(sc["rows"]),
            torch.cat(sc["attrs"]), dir4.contiguous())


def _shadow_args(sc, o4, dir4, tmax):
    """K10 walk arguments of the objects `sc` (_batch_scene) for camera
    4-origins o4, 4-dirs dir4 and tmax, with their live lists."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    mats, spheres = torch.stack(sc["mats"]), torch.cat(sc["spheres"])
    r_all, s_os = mb.object_rays(mats, o4, dir4)
    lists = mb.live_chunk_lists_multi(spheres, sc["counts"], r_all[:, 0:3], r_all[:, 6:9], s_os,
                                      valid=tmax > 0, enabled=sc["enabled"],
                                      lane_bound_shared=tmax)
    return (*lists, sc["cobj"], torch.stack(sc["boxes"]), mats, torch.cat(sc["rows"]),
            o4.contiguous(), dir4.contiguous(), tmax.contiguous())


def _dir4(dev, d):
    """Camera 4-dirs (-1, unit d) of dirs d (3, n)."""
    d = d / np.linalg.norm(d, axis=0)
    return torch.as_tensor(np.concatenate([np.full((1, d.shape[1]), -1.0), d]),
                           dtype=torch.float32, device=dev)


def _batch_args(dev, O, shadow, T=300, n=8192, kind=None):
    """K9 (shadow False) or K10 walk arguments for O random soups
    (_batch_scene, of `kind`) and n rays around the view axis; K10's origins
    spread around the camera, 20% of its lanes masked (tmax 0)."""
    rng = np.random.default_rng(O + 10 * shadow)
    d = rng.normal(size=(3, n)) * 0.1
    d[2] = 1.0
    dir4 = _dir4(dev, d)
    sc = _batch_scene(dev, O, shadow, T, rng, kind)
    if not shadow:
        return _shared_args(sc, dir4)
    o4 = torch.as_tensor(np.stack([rng.uniform(0.0, 0.5, n), rng.uniform(-1, 1, n),
                                   rng.uniform(-1, 1, n), rng.uniform(0.0, 5.0, n)]),
                         dtype=torch.float32, device=dev)
    tmax = torch.as_tensor(rng.uniform(2.0, 14.0, n), dtype=torch.float32, device=dev)
    tmax[torch.as_tensor(rng.uniform(size=n) < 0.2, device=dev)] = 0.0
    return _shadow_args(sc, o4, dir4, tmax)


def _first_bounds(args):
    """K9's per-lane first bound of walk arguments `args`: the max over
    objects of the union-box exit in shared units, as its twin computes it."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    boxes, mats, dir4 = args[4], args[5], args[-1]
    dh, s = mb.object_dirs(mats, dir4)
    return torch.stack([mk._box_bound(bx[0:3], bx[3:6], bx[6:9], dh[g]) * s[g]
                        for g, bx in enumerate(boxes)]).amax(dim=0)


def _coverage_args(dev, O, pattern, T=300, n=8192):
    """K9 walk arguments at a coverage pattern (COVERAGE, "alternating") for
    O objects (_batch_scene): rays drawn around the view axis, classified
    by the twin, and picked. "all_hit" and "ties": every lane a ray that
    hits; "silhouette": the upper half of every block rays that miss every
    mesh inside some union box (bound above 0), the lower half rays that
    hit; "all_miss": every ray looking away; "alternating": the column
    pair, rays along it."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    rng = np.random.default_rng(100 + O)
    kind = pattern if pattern in ("ties", "alternating") else None
    sc = _batch_scene(dev, O, False, 256 if kind == "alternating" else T, rng, kind)
    spread = 0.012 if kind == "alternating" else 0.1
    if pattern == "all_miss":
        d = rng.normal(size=(3, n)) * 0.3
        d[2] = -1.0
        return _shared_args(sc, _dir4(dev, d))
    d = rng.normal(size=(3, 8 * n)) * spread
    d[2] = 1.0
    pool = _shared_args(sc, _dir4(dev, d))
    hit = (mb.batched_shared_walk_plain(*pool)[3] >= 0).cpu().numpy()
    hits = np.flatnonzero(hit)
    pick = rng.choice(hits, n)
    if pattern == "silhouette":
        edge = np.flatnonzero(~hit & (_first_bounds(pool) > 0).cpu().numpy())
        upper = np.arange(n) % 1024 >= 512
        pick[upper] = rng.choice(edge, int(upper.sum()))
    return _shared_args(sc, pool[-1][:, torch.as_tensor(pick, device=dev)])


def _activity_args(dev, O, pattern, T=300, n=8192):
    """K10 walk arguments at an activity pattern (ACTIVITY, "alternating")
    for O objects (_batch_scene, object 1 disabled), the masked lanes' rays
    garbage (finite): origins spread around the camera, tmax 2-14;
    "alternating": the column pair, rays from in front of it along it, every
    lane active."""
    rng = np.random.default_rng(200 + O)
    alternating = pattern == "alternating"
    sc = _batch_scene(dev, O, True, 256 if alternating else T, rng,
                      "alternating" if alternating else None)
    d = rng.normal(size=(3, n)) * (0.012 if alternating else 0.1)
    d[2] = 1.0
    dir4 = _dir4(dev, d)
    o4 = torch.as_tensor(np.stack([rng.uniform(0.0, 0.5, n), rng.uniform(-1, 1, n),
                                   rng.uniform(-1, 1, n), rng.uniform(0.0, 5.0, n)]),
                         dtype=torch.float32, device=dev)
    if alternating:
        o4[1:3] = 0.0
        o4[3] = 0.0
    tmax = torch.as_tensor(rng.uniform(2.0, 14.0, n), dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev) if alternating else torch.as_tensor(
        ACTIVITY[pattern](rng, n), device=dev)
    garbage = torch.as_tensor(rng.uniform(-4, 4, (8, n)), dtype=torch.float32, device=dev)
    o4 = torch.where(active, o4, garbage[:4])
    dir4 = torch.where(active, dir4, garbage[4:])
    return _shadow_args(sc, o4, dir4, torch.where(active, tmax, 0.0))


def _k9_equals_twin(args):
    """K9 on args: one launch, every output equal to the twin's bit for bit.
    Returns the twin's outputs and the chunks each block walked."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    before = _launches("rpt_batched_shared_walk")
    got = mb.batched_shared_walk(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_batched_shared_walk") == before + 1
    *want, walked = mb.batched_shared_walk_plain(*args, walked=True)
    for part, g, w in zip(("t", "u", "v", "tri", "obj", "attr"), got, want):
        assert torch.equal(g, w), part
    return want, walked


def _k10_equals_twin(args):
    """K10 on args: one launch, equal to the twin bit for bit. Returns the
    twin's result and the chunks each block walked."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    before = _launches("rpt_batched_general_walk")
    got = mb.batched_general_walk(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_batched_general_walk") == before + 1
    want, walked = mb.batched_general_walk_plain(*args, walked=True)
    assert torch.equal(got, want)
    return want, walked


# A pool of 33 objects of 768 chunks (the most a mesh below the large tier
# holds): 25,344 chunks, whose live lists run past the head that the walks
# stage in shared memory (FlatList::kStageMax, csrc/walk.cuh).
LARGE_POOL = {"T": 24_576, "n": 2048, "kind": "sparse"}
STAGE_MAX = 1024


@pytest.mark.parametrize("O", [2, 8])
def test_batched_shared_walk_kernel_matches_twin(cuda, O):
    """K9 on 2 and 8 objects: t, u, v, triangle ids, object slots and
    attributes equal to the twin's bit for bit; every object wins
    somewhere."""
    want, _ = _k9_equals_twin(_batch_args(cuda, O, shadow=False))
    hit = want[3] >= 0
    assert float(hit.float().mean()) > 0.1 and len(set(want[4][hit].tolist())) == O


@pytest.mark.parametrize("O", [2, 8])
def test_batched_general_walk_kernel_matches_twin(cuda, O):
    """K10 on 2 and 8 objects, one disabled: equal to the twin bit for bit,
    both verdicts present, the result min(hit, tmax)."""
    args = _batch_args(cuda, O, shadow=True)
    want, _ = _k10_equals_twin(args)
    tmax = args[9]
    rel = tmax > 0
    assert bool((want <= tmax).all())
    assert int((want < tmax)[rel].sum()) > 50 and int((want >= tmax)[rel].sum()) > 50


K9_CASES = [*((O, p) for O in (2, 8) for p in COVERAGE if p != "box_plane"), (2, "alternating"),
            (120, "many_objects"), (2, "box_plane"), (33, "large_pool")]
K10_CASES = [*((O, p) for O in (2, 8) for p in ACTIVITY), (2, "alternating"),
             (40, "many_objects"), (33, "large_pool")]


@pytest.mark.parametrize("O,pattern", K9_CASES, ids=[f"{p}-O{O}" for O, p in K9_CASES])
def test_batched_shared_walk_kernel_equals_twin_at_any_coverage(cuda, O, pattern):
    """K9 equal to its twin bit for bit at the coverage patterns of
    _coverage_args on 2 and 8 objects (every lane hits; silhouette blocks;
    every lane misses the union boxes; exact ties inside a chunk, across
    chunks and across objects), on a pair whose lists alternate objects
    chunk by chunk, on 120 objects (more than the 16 whose rays a CTA
    stages at once, and more than the card's shared memory could hold at
    once: the tiles are staged again as the walk moves between them), on
    box_plane_batch (rays along a union box's face with an exact-zero
    direction component), and on a pool of 25,344 chunks (LARGE_POOL) whose
    walks read their lists past the staged head from global memory."""
    from torch_port_fixtures import box_plane_batch

    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    if pattern == "box_plane":
        seen = {}
        real = mb.batched_shared_walk
        mb.batched_shared_walk = lambda *a: seen.setdefault("args", a) and real(*a)
        try:
            mb.batched_nearest_shared(*box_plane_batch(cuda))
        finally:
            mb.batched_shared_walk = real
        args = seen["args"]
    elif pattern == "many_objects":
        args = _batch_args(cuda, O, shadow=False, T=100, n=4096)
    elif pattern == "large_pool":
        args = _batch_args(cuda, O, shadow=False, **LARGE_POOL)
    else:
        args = _coverage_args(cuda, O, pattern)
    want, walked = _k9_equals_twin(args)
    hit = (want[3] >= 0).reshape(-1, 1024)
    switches = mb.object_switches(args[0], args[3], walked)
    if pattern in ("all_hit", "ties"):
        assert bool(hit.all())
    if pattern == "silhouette":
        assert bool(hit[:, :512].all()) and not bool(hit[:, 512:].any())
    if pattern == "all_miss":
        assert not bool(hit.any()) and int(walked.sum()) == 0
    if pattern == "ties":
        assert bool((want[4] == 0).any())  # object 1 repeats object 0: its hits tie there
    if pattern == "alternating":
        assert int(switches.sum()) * 2 > int(walked.sum()) > 0
    if pattern == "many_objects":  # the walks move between tiles of 16 objects
        assert len(set(want[4][want[4] >= 0].tolist())) > 16
        assert int(mb.object_switches(args[0], args[3] // 16, walked).sum()) > 0
    if pattern == "box_plane":
        assert int(walked[1]) > 0 and not bool(hit[1].any())
    if pattern == "large_pool":
        assert args[3].numel() > 25_000 and int(walked.max()) > STAGE_MAX and bool(hit.any())


@pytest.mark.parametrize("O,pattern", K10_CASES, ids=[f"{p}-O{O}" for O, p in K10_CASES])
def test_batched_general_walk_kernel_equals_twin_at_any_activity(cuda, O, pattern):
    """K10 equal to its twin bit for bit at the four activity patterns on
    2 and 8 objects (object 1 disabled; the masked lanes' rays garbage), on
    a pair whose lists alternate objects chunk by chunk, on 40 objects
    (more than the 8 whose rays a CTA stages at once, and more than the
    card's shared memory could hold at once), and on a pool of 25,344
    chunks (LARGE_POOL) whose walks read their lists past the staged head
    from global memory."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb

    if pattern == "many_objects":
        args = _batch_args(cuda, O, shadow=True, T=100, n=4096)
    elif pattern == "large_pool":
        args = _batch_args(cuda, O, shadow=True, **LARGE_POOL)
    else:
        args = _activity_args(cuda, O, pattern)
    want, walked = _k10_equals_twin(args)
    tmax = args[9]
    active = tmax > 0
    n_active = int(active.sum())
    assert n_active == {"one_per_block": 8, "all_masked": 0, "all_active": 8192,
                        "alternating": 8192}.get(pattern, n_active)
    if pattern == "all_masked":
        assert bool((want == 0.0).all())
    if pattern in ("scattered", "all_active", "alternating", "many_objects", "large_pool"):
        assert int((want < tmax)[active].sum()) > 20 and int((want >= tmax)[active].sum()) > 20
    if pattern == "alternating":
        switches = mb.object_switches(args[0], args[3], walked)
        assert int(switches.sum()) * 2 > int(walked.sum()) > 0
    if pattern == "many_objects":  # the walks move between tiles of 8 objects
        assert int(mb.object_switches(args[0], args[3] // 8, walked).sum()) > 0
    if pattern == "large_pool":
        assert args[3].numel() > 25_000 and int(walked.max()) > STAGE_MAX


@pytest.mark.parametrize("xl", [False, True], ids=["s32", "s128"])
def test_large_walk_kernels_match_twins(cuda, monkeypatch, xl):
    """K11 and K12 on a 3,000-triangle soup (96 chunks, the last 24
    triangles masked by T) over superchunks of 32, and of 128 from the
    super-sphere cull (SUPER_CULL_C forced to 0): each equal to its twin bit
    for bit, as K5's and K6's tests hold them."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    if xl:
        monkeypatch.setattr(ml, "SUPER_CULL_C", 0)
    args = _soup_lists(cuda, shadow=False, T=3000, seed=5, large=True)
    assert args[-3] == (128 if xl else 32)
    before = _launches("rpt_large_shared_walk")
    got = ml.large_shared_walk(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_large_shared_walk") == before + 1
    want = ml.large_shared_walk_plain(*args)
    assert bool((want[3] >= 0).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    args = _soup_lists(cuda, shadow=True, T=3000, seed=5, large=True)
    got, want = ml.large_general_walk(*args), ml.large_general_walk_plain(*args)
    assert torch.equal(got, want)
    tmax = args[7][0]
    rel = tmax > 0
    assert torch.equal((got >= tmax)[rel], (want >= tmax)[rel])
    assert bool((got <= tmax).all())
    assert int((want < tmax)[rel].sum()) > 50 and int((want >= tmax)[rel].sum()) > 50


@pytest.mark.parametrize("pattern", list(ACTIVITY))
@pytest.mark.parametrize("walk", ["K6", "K12_s32", "K12_s128"])
def test_shadow_walk_kernels_equal_twins_at_any_activity(cuda, monkeypatch, walk, pattern):
    """K6 (600 triangles) and K12 (3,000 triangles, so the last 24 of 96
    chunks' triangles are masked by T; superchunks of 32, and of 128 from the
    super-sphere cull) equal their twins bit for bit at four activity
    patterns: 5% of the lanes scattered, one lane per block, every lane
    masked, every lane active. The masked lanes' rays are garbage."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    large = walk != "K6"
    if walk == "K12_s128":
        monkeypatch.setattr(ml, "SUPER_CULL_C", 0)
    args = _soup_lists(cuda, shadow=True, T=3000 if large else 600, seed=7, large=large,
                       pattern=pattern)
    if large:
        assert args[-3] == (128 if walk == "K12_s128" else 32)
    key = "rpt_large_general_walk" if large else "rpt_general_walk"
    fn = ml.large_general_walk if large else mk.general_walk
    before = _launches(key)
    got = fn(*args)
    torch.cuda.synchronize()
    assert _launches(key) == before + 1
    want = (ml.large_general_walk_plain if large else mk.general_walk_plain)(*args)
    assert torch.equal(got, want)
    tmax = args[7 if large else 6][0]
    active = tmax > 0
    n_active = int(active.sum())
    assert n_active == {"scattered": n_active, "one_per_block": 8, "all_masked": 0,
                        "all_active": 8192}[pattern]
    if pattern == "all_masked":
        assert bool((got == 0.0).all())
    if pattern in ("scattered", "all_active"):
        assert int((want < tmax)[active].sum()) > 50 and int((want >= tmax)[active].sum()) > 50


@pytest.mark.parametrize("pattern", COVERAGE)
@pytest.mark.parametrize("walk", ["K5", "K11_s32", "K11_s128"])
def test_shared_walk_kernels_equal_twins_at_any_coverage(cuda, monkeypatch, walk, pattern):
    """K5 (600 triangles) and K11 (3,000 triangles, the last 24 of 96 chunks'
    triangles masked by T; superchunks of 32, and of 128 from the
    super-sphere cull) equal their twins bit for bit in t, u, v, triangle id
    and attributes at five coverage patterns (COVERAGE): every lane hits;
    half of every block's lanes miss the mesh inside its union box
    (silhouette blocks); every lane misses the union box; exact ties (a
    triangle repeated inside its chunk and another across two chunks); half
    of every block's rays along the union box's lo.x plane with an
    exact-zero x direction, from a camera on that plane. On
    the first two, K5 and K11_s32 stop their walks early (12 of 24 and 64 of
    96 chunks), so a speculative chunk is dropped."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    large = walk != "K5"
    if walk == "K11_s128":
        monkeypatch.setattr(ml, "SUPER_CULL_C", 0)
    T = 3000 if large else 600
    args = _soup_lists(cuda, shadow=False, T=T, seed=9, large=large, pattern=pattern)
    if large:
        assert args[-3] == (128 if walk == "K11_s128" else 32)
    key = "rpt_large_shared_walk" if large else "rpt_shared_walk"
    before = _launches(key)
    got = (ml.large_shared_walk if large else mk.shared_walk)(*args)
    torch.cuda.synchronize()
    assert _launches(key) == before + 1
    want = (ml.large_shared_walk_plain if large else mk.shared_walk_plain)(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hit = (want[3] >= 0).reshape(-1, 1024)
    if pattern == "all_hit":
        assert bool(hit.all())
    if pattern == "silhouette":
        assert bool(hit[:, :512].all()) and not bool(hit[:, 512:].any())
    if pattern == "all_miss":
        assert not bool(hit.any()) and bool((want[0] == 1e20).all())
        assert not bool(want[4].any())
    if pattern == "box_plane":
        assert bool(hit[:, :512].all()) and not bool(hit[:, 512:].any())
    if pattern == "ties":
        inside, across = _column_soup(np.random.default_rng(9), T, pattern)[2]
        tri = want[3].cpu().numpy()
        assert np.isin(tri, inside).mean() > 0.15 and not np.isin(tri, inside + 1).any()
        assert np.isin(tri, np.concatenate([across, across + 31])).mean() > 0.15


@pytest.mark.parametrize("kind", ["instances", "forced_large"])
def test_batched_and_large_card_frames_match_cpu_frames(cuda, tmp_path, kind):
    """The instances fixture (K9, K10) and the blob forced into the large
    tier (K11, K12) at 256x192, moving camera: the card's frame against the
    port's CPU frame, parity rule, equal counts; K5/K6 never launched."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as mi
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    host = pt.load_scene_file(write_demo_scene(
        str(tmp_path), 3, "instances" if kind == "instances" else "blob"))
    mi.LARGE_MODE = kind == "forced_large" or None
    try:
        scene, meta = pt.build_scene(host, device=cuda)
        cpu_scene, cpu_meta = pt.build_scene(host, device="cpu")
    finally:
        mi.LARGE_MODE = None
    state = ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0))
    before = collections.Counter(_build.LAUNCHES)
    img, aux = pt.build_render_fn(meta, 256, 192, -1, with_aux=True, device=cuda)(
        scene, pt.FrameState(torch.tensor(state[0], device=cuda),
                             torch.tensor(state[1], device=cuda)))
    torch.cuda.synchronize()
    ran = {k for k, v in (_build.LAUNCHES - before).items() if v}
    walks = ({"rpt_batched_shared_walk", "rpt_batched_general_walk"} if kind == "instances"
             else {"rpt_large_shared_walk", "rpt_large_general_walk"})
    assert walks <= ran and not ran & {"rpt_shared_walk", "rpt_general_walk"}
    ref, ref_aux = pt.build_render_fn(cpu_meta, 256, 192, -1, with_aux=True, device="cpu")(
        cpu_scene, pt.FrameState(torch.tensor(state[0]), torch.tensor(state[1])))
    diff = (img.cpu() - ref).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) <= 0.002
    assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in ref_aux.items()}
    assert int(aux["hits"]) > 0 and 0 < int(aux["lit_rays"]) < int(aux["shadow_rays"])


def test_xl_lists_on_the_large_fixture(cuda, tmp_path, monkeypatch):
    """The level-7 fixture with the super-sphere cull forced (SUPER_CULL_C =
    0): superchunks of 128, so 80 of them; its 512x384 frame against the
    frame of the default lists (superchunks of 32), parity rule, equal
    counts. The forced frame runs eagerly (`render_constants`,
    `trace_frame`): the renderer's CUDA graph replays the lists it captured
    and reads no module setting again, as a jitted frame would not."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(str(tmp_path), 4, "large")),
                                 device=cuda)
    state = pt.FrameState(torch.tensor([0.3, 0.0, 0.4], device=cuda),
                          torch.tensor([0.7, 0.0, 0.0, 0.0], device=cuda))
    render = pt.build_render_fn(meta, 512, 384, -1, with_aux=True, device=cuda)
    base, base_aux = render(scene, state)
    seen = []
    real = ml.large_shared_walk
    monkeypatch.setattr(ml, "SUPER_CULL_C", 0)
    monkeypatch.setattr(ml, "large_shared_walk",
                        lambda *a: seen.append((a[0].shape[1], a[-3])) or real(*a))
    consts = prender.render_constants(meta, 512, 384, 1, cuda)
    with prender.full_precision():
        img, aux = prender.trace_frame(scene, meta, state, *consts, -1, 512, 384, True)
    assert seen == [(80, 128)]
    diff = (img - base).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) <= 0.002
    assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in base_aux.items()}


def test_largedemo_on_the_bunny_stand_in(cuda, tmp_path, monkeypatch):
    """utils/largedemo.large_parity_and_time on bunny's stand-in subdivided
    once (19,872 triangles) at 256x192, LARGE_MODE forced and SUPER_CULL_C
    at 0, so the XL tier's route (live_chunk_lists3, supers of 128) on a
    small mesh: ok against the C++ oracle, a positive frame time."""
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as mi
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml
    from relativitypathtracer_tpu_torch.utils import largedemo
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_bunny_stand_in

    src = write_bunny_stand_in(str(tmp_path / "Models" / "bunny_stand_in.obj"))
    taken, real = [], ml.live_chunk_lists3
    monkeypatch.setattr(mi, "LARGE_MODE", True)
    monkeypatch.setattr(ml, "SUPER_CULL_C", 0)
    monkeypatch.setattr(ml, "live_chunk_lists3",
                        lambda *a, **k: taken.append(k["s"]) or real(*a, **k))
    res = largedemo.large_parity_and_time(256, 192, frames=5, workdir=str(tmp_path), levels=1,
                                          device=cuda, src_obj=src)
    assert res["ok"] and res["tris"] == 19_872 and res["frame_ms"] > 0, res
    assert taken and set(taken) == {128}


# --- K4: the live-chunk list build ----------------------------------------------

K4_KEYS = ("rpt_cone_table", "rpt_live_cull", "rpt_bucket_order")


def _same(got, want) -> bool:
    """Equal to the bit: floats compared as their int32 bits."""
    if got is None or want is None:
        return got is None and want is None
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def _k4_equals_twin(fn, plain, *args, **kw):
    """A list function on CUDA inputs: K4's three kernels launched, every
    output equal to the twin's on the same inputs to the bit. Returns the
    twin's outputs."""
    before = [_launches(k) for k in K4_KEYS]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert all(_launches(k) > b for k, b in zip(K4_KEYS, before))
    want = plain(*args, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), i
    return want


def _captured(mod, attr, build):
    """The (args, kwargs) of every call of mod.attr while build() runs."""
    calls, real = [], getattr(mod, attr)

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    setattr(mod, attr, rec)
    try:
        build()
    finally:
        setattr(mod, attr, real)
    return calls


K4_CASES = ("flat_shared", "flat_shadow", "flat_rows", "lists2_ragged", "lists3", "pool_shared",
            "pool_shadow_one_disabled", "large_pool", "grazing", "all_dead", "all_live",
            "pool_straddling")
PRETEST_CASES = K4_CASES[-4:]  # the cull's group pre-test, through live_cull itself


def _grazing_spheres(rng, rows, C, kappa):
    """C chunk spheres in groups of 32, each group placed against one cone
    row of `rows` (numpy (n, CONE_COLS)): the base sphere tangent to the
    cone within a few ulps of the angle or anywhere within three times the
    pre-test's angular margin kappa, repeated, jittered by ulps, or holding
    31 small spheres; numpy float32."""
    G = -(-C // 32)
    q = rows[rng.integers(0, rows.shape[0], G)].astype(np.float64)
    apex, axis, o = q[:, 0:3], q[:, 3:6], q[:, 8]
    a = np.arccos(np.clip(q[:, 6], -1.0, 1.0))
    D, r = rng.uniform(3.0, 9.0, G), rng.uniform(0.05, 0.3, G)
    delta = np.where(rng.uniform(size=G) < 0.5, rng.integers(-6, 7, G) * 2.0 ** -23,
                     rng.uniform(-3 * kappa, 3 * kappa, G))
    theta = a + np.arcsin(np.minimum((r + o) / D, 1.0)) + delta
    perp = rng.normal(size=(G, 3))
    perp -= (perp * axis).sum(1, keepdims=True) * axis
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    centre = apex + D[:, None] * (np.cos(theta)[:, None] * axis + np.sin(theta)[:, None] * perp)
    sph = np.repeat(np.concatenate([centre, r[:, None]], axis=1)[:, None], 32, axis=1)
    jit, inner = np.arange(G) % 3 == 1, np.arange(G) % 3 == 2
    sph[jit, :, :3] *= 1.0 + rng.integers(-4, 5, (int(jit.sum()), 32, 3)) * 2.0 ** -23
    sph[inner, 1:, :3] += rng.uniform(-0.25, 0.25, (int(inner.sum()), 31, 3)) * r[inner, None, None]
    sph[inner, 1:, 3] = 0.25 * r[inner, None]
    return sph.reshape(-1, 4)[:C].astype(np.float32)


def _pretest_inputs(dev, case):
    """The inputs of a pre-test case: a list of (spheres, table, sub,
    use_bound, cobj, smin) and the pre-test's dead count each must give
    (None: unknown, above 0). grazing, all_dead, all_live: 10,227 chunks
    (320 groups, the last of 19) against 124 blocks' sub-cones, so a warp
    takes 8 blocks (the last warp 4) flat and at S = 32, 2 at S = 128;
    grazing for shared rays and for shadow rays with a lane bound, every
    group tangent to a sub-cone; all_dead: every chunk behind the rays;
    all_live: every chunk sphere around the rays' origins. pool_straddling:
    3 objects of 77 chunks, so groups 2 and 4 hold two objects; every chunk
    dead but group 3's, object 2 disabled, smin with a zero and a NaN: only
    groups 0, 1, 5, 6 and 7 may be skipped."""
    from torch_port_fixtures import list_rays, list_spheres

    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    rng = np.random.default_rng(300 + K4_CASES.index(case))
    dt = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    if case == "pool_straddling":
        rays = [list_rays(rng, n=8192, spread=0.05) for _ in range(3)]
        table = mk.cone_table(dt(np.stack([r[0] for r in rays])),
                              dt(np.stack([r[1] for r in rays])))
        table[2, :, mk.CONE_COLS - 1] = 0.0
        sph = list_spheres(rng, 231)
        sph[:, 2] *= -1.0  # behind the rays
        sph[96:128, 2] *= -1.0  # group 3 (object 1 only) in front
        smin = rng.uniform(0.5, 2.0, (3, 8)).astype(np.float32)
        smin[0, 3], smin[1, 5] = 0.0, np.nan
        cobj = np.repeat(np.arange(3, dtype=np.int32), 77)
        return [((dt(sph), table, mk.SUB, False, dt(cobj), dt(smin)), 5 * 8)]
    B, C = 124, 10227
    out = []
    for shadow in ((False, True) if case == "grazing" else (False,)):
        d, o, valid, bound = list_rays(rng, n=B * 1024, spread=0.05, shadow=shadow)
        table = mk.cone_table(dt(d), dt(o), dt(valid) if shadow else None,
                              dt(bound) if shadow else None)
        if case == "grazing":
            sph, want = _grazing_spheres(rng, table.cpu().numpy(), C, mk.GROUP_KAPPA), None
        elif case == "all_dead":
            sph, want = list_spheres(rng, C) * np.float32([1, 1, -1, 1]), B * 320
        else:
            sph, want = list_spheres(rng, C) * np.float32([0, 0, 0, 100]), 0
        out.append(((dt(sph), table, mk.SUB, shadow, None, None), want))
    return out


def _cull_pretest_equals_twin(dev, case):
    """rpt_live_cull with its group pre-test equal to live_cull_plain to the
    bit in the flat variant, at S = 32 and at S = 128 (floors, overlap, bit
    words, super floors and liveness); its skip counter equal to the
    pre-test's plain form in every variant."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    for (spheres, table, sub, use_bound, cobj, smin), want in _pretest_inputs(dev, case):
        C = spheres.shape[0]
        dead = int((~mk.group_may_overlap_plain(spheres, table, sub, use_bound, cobj)).sum())
        assert dead == want if want is not None else dead > 0
        for s, n_words in ((0, 0), (32, -(-C // 32)), (128, -(-C // 128) * 4)):
            skipped = torch.zeros(1, dtype=torch.int32, device=dev)
            before = _launches("rpt_live_cull")
            got = mk.live_cull(spheres, table, sub, use_bound, cobj, smin, s, n_words,
                               skipped=skipped)
            torch.cuda.synchronize()
            assert _launches("rpt_live_cull") == before + 1
            want_out = mk.live_cull_plain(spheres, table, sub, use_bound, cobj, smin, s, n_words)
            for i, (g, w) in enumerate(zip(got, want_out)):
                assert _same(g, w), (s, i)
            assert int(skipped) == dead, (s, int(skipped), dead)
            if not s:
                mind, over = want_out
        if case == "all_live":
            assert bool(over.all())
        if case == "pool_straddling":  # the zero and NaN smin reach the floors
            assert bool(torch.isnan(mind[5, 77:154]).all()) and bool((mind[3, :77] == 0).all())


@pytest.mark.parametrize("case", K4_CASES)
def test_list_kernels_equal_twins(cuda, case):
    """K4 (rpt_cone_table, rpt_live_cull, rpt_bucket_order) equal to its
    twins to the bit in order, floors, counts and bits: flat lists of 160
    chunks over 8 blocks for shared rays (a stride-0 origin) and for shadow
    rays (masked lanes, two all-masked sub-cones, a lane bound), those also
    read as rows 0-2 and 6-8 of a (10, n) array; lists2 at S = 32 on a ragged 333 chunks (a
    last bit word and super of 13); lists3 at S = 128 on 1,000 chunks (the
    super-sphere cull and the block-cone bits); the pool of 4 objects for
    K9's lists, and for K10's with object 1 disabled; and the 25,344-chunk
    pool of 33 objects (LARGE_POOL). The cull's group pre-test: the kernel
    equal to the twin to the bit, flat and at S = 32 and 128, and its skip
    counter equal to the pre-test's plain form, on grazing chunks (above
    0), all-dead (every group skipped) and all-live chunks (none), and on
    a pool whose groups straddle objects (never skipped)."""
    if case in PRETEST_CASES:
        return _cull_pretest_equals_twin(cuda, case)
    from torch_port_fixtures import list_rays, list_spheres

    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    if case.startswith("pool") or case == "large_pool":
        shadow = case != "pool_shared"
        kw = LARGE_POOL if case == "large_pool" else {}
        O = 33 if case == "large_pool" else 4
        calls = _captured(mb, "live_chunk_lists_multi",
                          lambda: _batch_args(cuda, O, shadow=shadow, **kw))
        assert len(calls) == 1
        a, k = calls[0]
        if shadow:
            assert k["enabled"][1] is False and sum(k["enabled"]) == O - 1
        order, minds, counts = _k4_equals_twin(mb.live_chunk_lists_multi,
                                               mb.live_chunk_lists_multi_plain, *a, **k)
        assert int(counts.sum()) > 0 and order.shape[1] == sum(a[1])
        if shadow:  # the disabled object's chunks are never live
            c0 = a[1][0]
            live = torch.arange(order.shape[1], device=cuda)[None, :] < counts[:, None].long()
            dead = (order >= c0) & (order < c0 + a[1][1])
            assert not bool((dead & live).any())
        return
    rng = np.random.default_rng(300 + K4_CASES.index(case))
    C = {"lists2_ragged": 333, "lists3": 1000}.get(case, 160)
    d, o, valid, bound = list_rays(rng, n=8192, spread=0.05, shadow=case != "flat_shared")
    args = [torch.as_tensor(x, device=cuda) for x in (list_spheres(rng, C), d, o)]
    if case == "flat_shared":  # the primary walk's stride-0 origin
        args[2] = args[2][:, :1].expand(3, 8192)
    if case == "flat_rows":  # the shadow walk's rows of r10
        r10 = torch.cat([args[1], torch.zeros_like(args[1]), args[2], torch.ones_like(args[1][:1])])
        args[1:] = [r10[0:3], r10[6:9]]
    kw = {} if case == "flat_shared" else {
        "valid": torch.as_tensor(valid, device=cuda), "lane_bound": torch.as_tensor(bound,
                                                                                    device=cuda)}
    if case.startswith("flat"):
        out = _k4_equals_twin(mk.live_chunk_lists, mk.live_chunk_lists_plain, *args, **kw)
    elif case == "lists2_ragged":
        out = _k4_equals_twin(mk.live_chunk_lists2, mk.live_chunk_lists2_plain, *args, s=32, **kw)
        assert out[3].shape == (8, 11) and out[0].shape == (8, 11)
    else:
        out = _k4_equals_twin(mk.live_chunk_lists3, mk.live_chunk_lists3_plain, *args, s=128,
                              **kw)
        assert out[3].shape == (8, 32) and out[0].shape == (8, 8)
    counts = out[2]
    assert int(counts.sum()) > 0
    if case == "flat_shared":  # narrow cones: some chunks culled
        assert int((counts < C).sum()) > 0


@pytest.mark.parametrize("n", [1, 45, 256, 700, 2100])
def test_bucket_order_kernel_keeps_ties_and_empty_blocks(cuda, n):
    """rpt_bucket_order equal to its twin to the bit on rows of n entries:
    one entry, a ragged tile, one full tile of the kernel (256), and rows of
    several tiles: all ties (the stable order is by entry id), nothing live (hi = -INF, the span clamped to 1e-6), every
    entry live, floors drawn from four values (ties across tiles in every
    bucket), random floors with 40% live, and nothing live over random
    floors."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    rng = np.random.default_rng(400 + n)
    mind = rng.uniform(0.0, 5.0, (6, n)).astype(np.float32)
    over = rng.uniform(size=(6, n)) < 0.4
    mind[0] = 1.0
    over[0] = True
    over[1] = False
    over[2] = True
    mind[3] = rng.choice(np.array([0.5, 1.0, 2.5, 4.0], np.float32), n)
    over[5] = False
    args = (torch.as_tensor(mind, device=cuda), torch.as_tensor(over, device=cuda))
    before = _launches("rpt_bucket_order")
    got = mk.bucket_order(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_bucket_order") == before + 1
    want = mk.bucket_order_plain(*args)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert got[0][0].tolist() == list(range(n)) and got[0][1].tolist() == list(range(n))
    assert got[2].tolist()[:3] == [n, 0, n] and int(got[2][5]) == 0


CONE_CASES = ("sub_shared_origin", "sub_masked_bounds", "block_masked", "block_shared_origin",
              "lane_stride_2", "pool_shared", "pool_shadow_disabled")


def _cone_inputs(dev, case):
    """cone_table's arguments (d, o, valid, lane_bound, lanes, s, enabled)
    for a card case, on 8 blocks of 1024 lanes: shadow-like rays with masked
    lanes (the first 256, and all of block 2: all-masked sub-cones and an
    all-masked block), a lane bound with a NaN and an INF; the shared
    origin expanded with stride 0; every other lane of a wider array; the
    pool as (3, 10, n) rays read through rows 0-2 and 6-8, a zero scale, and
    object 1 disabled."""
    from torch_port_fixtures import list_rays

    rng = np.random.default_rng(600 + CONE_CASES.index(case))
    n = 8192
    dt = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    d, o, valid, bound = list_rays(rng, n=n, spread=0.3, shadow=True)
    valid[2048:3072] = False
    bound[5], bound[700] = np.nan, np.inf
    lanes = 1024 if case.startswith("block") else 128
    if case in ("sub_shared_origin", "block_shared_origin"):
        return dt(d), dt(o[:, :1]).expand(3, n), None, None, lanes, None, None
    if case in ("sub_masked_bounds", "block_masked"):
        return dt(d), dt(o), dt(valid), dt(bound), lanes, None, None
    if case == "lane_stride_2":
        wide = dt(np.repeat(np.stack([d, o]), 2, axis=2))
        return wide[0, :, ::2], wide[1, :, 1::2], dt(valid), dt(np.repeat(bound, 2))[::2], 128, \
            None, None
    O = 3
    rays = [list_rays(rng, n=n, spread=0.3, shadow=True) for _ in range(O)]
    r10 = np.zeros((O, 10, n), np.float32)
    r10[:, 0:3] = np.stack([r[0] for r in rays])
    r10[:, 6:9] = np.stack([r[1] for r in rays])
    r10 = dt(r10)
    s = rng.uniform(0.5, 2.0, (O, n)).astype(np.float32)
    s[2, 5] = 0.0
    if case == "pool_shared":
        ro = dt(rng.uniform(-0.2, 0.2, (O, 3)).astype(np.float32))
        return r10[:, 0:3], ro[:, :, None].expand(O, 3, n), None, None, 128, dt(s), None
    return (r10[:, 0:3], r10[:, 6:9], dt(valid), dt(bound), 128, dt(s),
            dt(np.array([1, 0, 1], np.int32)))


@pytest.mark.parametrize("case", CONE_CASES)
def test_cone_table_kernel_equals_twin(cuda, case):
    """rpt_cone_table equal to cone_table_plain on the card, to the bit, in
    every row (and the pool's smin): 128- and 1024-lane groups, masked lanes
    with all-masked groups, NaN and INF lane bounds, a stride-0 origin,
    strided views, and the pool's glue with a disabled object."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    args = _cone_inputs(cuda, case)
    before = _launches("rpt_cone_table")
    got = mk.cone_table(*args)
    torch.cuda.synchronize()
    assert _launches("rpt_cone_table") == before + 1
    want = mk.cone_table_plain(*args)
    got, want = (got, want) if args[5] is not None else ((got,), (want,))
    for g, w in zip(got, want):
        assert _same(g, w)
    rows = got[0]
    if args[2] is not None:  # the all-masked groups
        assert not bool(rows[..., 16 // (args[4] // 128):24 // (args[4] // 128), 10].any())
        assert bool(torch.isnan(rows[..., 0, 9]).all())
    if case == "pool_shadow_disabled":
        assert bool((rows[1, :, 11] == 0).all()) and bool((rows[0, :, 11] == 1).all())
        assert bool((got[1][:, 2] == mk.INF).all())


def _large_walks_equal_twins(args, shadow):
    """K11 (or K12) on args equal to its twin bit for bit; returns the
    chunks each block walked (the twin's count) and the twin's result."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    S, C, T = args[-3:]
    lists = ml.super_cursor_lists(*args[:4], S, C)
    if shadow:
        got = ml.large_general_walk(*args)
        want, walked = mk.walk_general_lists(*lists, *args[4:8], T, walked=True)
        assert torch.equal(got, want)
        return walked, want
    got = ml.large_shared_walk(*args)
    *want, walked = mk.walk_shared_lists(*lists, *args[4:8], T, walked=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((want[3] >= 0).any())
    return walked, want


@pytest.mark.parametrize("walk", ["K11", "K12", "K11_s128", "K12_s128"])
def test_large_walks_read_lists_past_the_staged_head(cuda, monkeypatch, walk):
    """K11 and K12 over lists longer than SuperList's staged head (512
    supers and 512 bit words, csrc/mesh_kernels.cu): a soup of 543,990
    triangles (17,000 chunks), two ray blocks, every super live and every
    lane walking past the head, so the cursor reads what lies past it from
    global memory: at S = 32 (lists2, forced past SUPER_CULL_C) 532 supers
    and their 532 bit words; at S = 128 (lists3, SUPER_CULL_C at 0, the XL
    tier's route) 133 supers of four bit words each, 532 words, the last
    super ragged (104 chunks). The lists equal their twin's, the walks their
    twins' bit for bit; K12's lanes (every one active, tmax infinite) are
    partly occluded, so its equality holds the triangle tests too."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml

    xl = walk.endswith("_s128")
    monkeypatch.setattr(ml, "SUPER_CULL_C", 0 if xl else 20_000)
    shadow = walk.startswith("K12")
    build, plain = (("live_chunk_lists3", mk.live_chunk_lists3_plain) if xl
                    else ("live_chunk_lists2", mk.live_chunk_lists2_plain))
    out = []
    calls = _captured(ml, build, lambda: out.append(_soup_lists(
        cuda, shadow=shadow, T=543_990, n=2048, seed=11, large=True,
        pattern="all_active" if shadow else None)))
    args = out[0]
    supers = 133 if xl else 532
    assert args[-3:] == (128 if xl else 32, 17_000, 543_990)
    assert args[0].shape == (2, supers) and args[3].shape == (2, 532)
    a, k = calls[0]
    _k4_equals_twin(getattr(ml, build), plain, *a, **k)
    assert args[2].tolist() == [supers, supers]
    walked, want = _large_walks_equal_twins(args, shadow)
    assert int(walked.min()) > 512 * 32
    if shadow:
        tmax = args[7][0]
        assert int((want < tmax).sum()) > 50 and int((want >= tmax).sum()) > 50


@pytest.mark.parametrize("walk", ["K11", "K12"])
def test_large_walks_end_at_the_list_end(cuda, walk):
    """The one-past-end read: every super of every block live, the ragged
    last one (8 of 32 chunks below C = 72) last in the list, floors 0, so
    each walk runs every chunk and its cursor ends exactly at the list's
    end; K11 and K12 equal their twins bit for bit."""
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    shadow = walk == "K12"
    args = list(_soup_lists(cuda, shadow=shadow, T=2300, seed=12, large=True,
                            pattern="all_active" if shadow else None))
    S, C, T = args[-3:]
    assert (S, C) == (32, 72)
    B = args[0].shape[0]
    args[0] = torch.arange(3, dtype=torch.int32, device=cuda).repeat(B, 1)
    args[1] = torch.zeros((B, 3), device=cuda)
    args[2] = torch.full((B,), 3, dtype=torch.int32, device=cuda)
    args[3] = mk.pack_bits(torch.ones((B, C), dtype=torch.bool, device=cuda))
    walked, _ = _large_walks_equal_twins(args, shadow)
    assert walked.tolist() == [C] * B


@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("size", [(64, 48), (200, 120)])
def test_viewer_renderer_matches_static_renderer_on_the_card(cuda, fixture_scene, size, pool):
    """The viewer's renderer (dirs as an argument over the padded grid) on
    the card against build_render_fn(out_uint8=True) on the card, byte for
    byte; pooled (at the pad's own size), against the same box pool of the
    static float frame, packed."""
    from relativitypathtracer_tpu_torch import render as prender

    _, (scene, meta) = fixture_scene
    w, h = size
    ph, pw = prender._round_up(h, prender.TILE), prender._round_up(w, prender.TILE)
    if pool > 1:
        w, h = pw, ph
    state = prender.FrameState(torch.tensor([0.5, 0.0, 0.0], device=cuda),
                               torch.tensor([0.5, 0.0, 0.0, 0.0], device=cuda))
    got = prender.build_viewer_render_fn(meta, ph, pw, -1, pool, device=cuda)(
        scene, state, prender.viewer_dirs(w, h, ph, pw, device=cuda))
    assert got.device.type == "cuda" and got.shape == (ph // pool, pw // pool, 3)
    if pool == 1:
        want = prender.build_render_fn(meta, w, h, -1, out_uint8=True, device=cuda)(scene, state)
        assert torch.equal(got[:h, :w], want)
    else:
        full = prender.build_render_fn(meta, w, h, -1, device=cuda)(scene, state)
        assert torch.equal(got, prender.to_uint8(prender.box_pool(full, pool)))


def test_octree_walk_on_the_card_matches_its_cpu_run(cuda, fixture_scene):
    """The octree walk of a seeded 4,096-ray fan on the card against the
    same walk on the CPU: converged on both, the same hit/miss on every
    ray, t and uv within a relative 1e-6 (the same fp32 operations in the
    same order; a gather's or a library's last bit may differ)."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.ops.octree_traverse import octree_intersect

    host, (scene, meta) = fixture_scene
    cpu_scene, _ = pt.build_scene(host, device="cpu")
    rng = np.random.default_rng(11)
    d = rng.uniform(-0.35, 0.35, (3, 4096)).astype(np.float32)
    d[0] += 1.0 / 3.2
    d[1] += -0.2 / 3.2
    d[2] = 1.0
    i, root = meta.mesh_ids[0], meta.mesh_roots[0]
    runs = []
    for sc, dev in ((scene, cuda), (cpu_scene, torch.device("cpu"))):
        runs.append(octree_intersect(sc.mesh, root, sc.objects.m[i], sc.objects.inv_m[i],
                                     torch.zeros(3, device=dev), torch.as_tensor(d).to(dev)))
    (t, _, uv, valid, conv), (ct, _, cuv, cvalid, cconv) = runs
    assert conv and cconv
    assert torch.equal(valid.cpu(), cvalid) and int(cvalid.sum()) > 1000
    torch.testing.assert_close(t.cpu()[cvalid], ct[cvalid], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(uv.cpu()[:, cvalid], cuv[:, cvalid], rtol=1e-6, atol=1e-7)


def test_sharded_frame_on_logical_shards_equals_single(cuda, fixture_scene):
    """The sharded renderer on four logical shards of the card: its frame
    and counts equal build_render_fn's to the bit, its launches 4x a single
    frame's per kernel (each renderer's replay, after its capture)."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn

    _, (scene, meta) = fixture_scene
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=cuda),
                          torch.tensor([0.1, 0.0, 0.0, 0.0], device=cuda))
    launches = []
    outs = []
    for render in (pt.build_render_fn(meta, 256, 192, -1, with_aux=True, device=cuda),
                   build_sharded_render_fn(meta, 256, 192, -1, [cuda] * 4, with_aux=True)):
        render(scene, state)  # the capture
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        outs.append(render(scene, state))
        torch.cuda.synchronize()
        launches.append(dict(_build.LAUNCHES))
    (want, waux), (img, aux) = outs
    assert torch.equal(img, want)
    assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in waux.items()}
    assert launches[1] == {k: 4 * n for k, n in launches[0].items()}


def test_exported_frame_equals_live_on_the_card(cuda, fixture_scene):
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.utils import aot

    _, (scene, meta) = fixture_scene
    render = aot.load_render(aot.export_render(scene, meta, 256, 192, device=cuda))
    live = pt.build_render_fn(meta, 256, 192, meta.default_interval, device=cuda)
    for v in (0.0, 0.5):
        state = pt.FrameState(torch.tensor([v, 0.0, 0.0], device=cuda),
                              torch.tensor([0.1, 0.0, 0.0, 0.0], device=cuda))
        assert torch.equal(render(scene, state), live(scene, state))


# --- the frame as one CUDA graph (utils/frame_graph) -----------------------

GRAPH_STATES = [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)), ((0.5, 0.0, 0.0), (2 / 30, 0.0, 0.0, 0.0)),
                ((0.0, 0.3, 0.4), (0.1, 0.0, 0.0, 0.0))]


@pytest.fixture(scope="module")
def graph_scenes(cuda, tmp_path_factory):
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    return {kind: pt.build_scene(pt.load_scene_file(write_demo_scene(
        str(tmp_path_factory.mktemp(f"graph_{kind}")), 3, kind)), device=cuda)
        for kind in ("blob", "textured", "cubes", "instances")}


def _graph_state(cuda, i):
    import relativitypathtracer_tpu_torch as pt

    v, p = GRAPH_STATES[i]
    return pt.FrameState(torch.tensor(v, device=cuda), torch.tensor(p, device=cuda))


def _eager_frame(meta, scene, state, w, h, dev, with_aux=True):
    from relativitypathtracer_tpu_torch import render as prender

    consts = prender.render_constants(meta, w, h, 1, dev)
    with prender.full_precision():
        return prender.trace_frame(scene, meta, state, *consts, -1, w, h, with_aux)


def _counted_call(fn):
    from relativitypathtracer_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def _aux(aux):
    return {k: int(v) for k, v in aux.items()}


@pytest.mark.parametrize("kind", ["blob", "textured", "cubes", "instances"])
def test_graphed_frame_equals_the_eager_frame(cuda, graph_scenes, kind):
    """build_render_fn's graph on each fixture: one capture over three
    states and a second scene of the same shapes; every frame equal to the
    eager frame to the bit with equal counts; frames kept across later
    calls unchanged; a replay counts an eager frame's launches, the first
    call (warm-up and replay) twice that."""
    import relativitypathtracer_tpu_torch as pt

    scene, meta = graph_scenes[kind]
    render = pt.build_render_fn(meta, 160, 96, -1, with_aux=True, device=cuda)
    fresh = render.captures == 0  # a renderer is cached per arguments
    other = scene._replace(objects=scene.objects._replace(
        velocity=scene.objects.velocity.flip(0) * 0.8, color=scene.objects.color.roll(1, 1)))
    inputs = [(scene, _graph_state(cuda, i)) for i in range(3)] + [(other, _graph_state(cuda, 1))]
    kept = []
    for i, (sc, st) in enumerate(inputs):
        (img, aux), launches = _counted_call(lambda: render(sc, st))
        (want, waux), eager_launches = _counted_call(
            lambda: _eager_frame(meta, sc, st, 160, 96, cuda))
        assert torch.equal(img, want) and _aux(aux) == _aux(waux)
        first = i == 0 and fresh
        assert launches == {k: (2 if first else 1) * n for k, n in eager_launches.items()}
        kept.append((img, want))
    assert render.captures == 1
    for img, want in kept:
        assert torch.equal(img, want)
    assert not torch.equal(kept[0][0], kept[1][0])


def test_replay_check_holds_30_times_on_instances(cuda, graph_scenes):
    """chip_smoke.py's traced-replay check (replay_check: the kernel nodes of
    the replayed graph against the replay's launch counts) on instances at
    1024x768, 30 times in one process after a textured frame: the same
    verdict, a pass, every time. The profiler trace it prints is no part of
    the verdict; how many of the 30 traces lacked a kernel is printed (-s)."""
    import importlib.util
    import pathlib

    import relativitypathtracer_tpu_torch as pt

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene, meta = graph_scenes["textured"]
    pt.build_render_fn(meta, 1024, 768, -1, with_aux=True, device=cuda)(
        scene, _graph_state(cuda, 1))
    scene, meta = graph_scenes["instances"]
    render = pt.build_render_fn(meta, 1024, 768, -1, with_aux=True, device=cuda)
    state = _graph_state(cuda, 1)
    render(scene, state)
    _, per_frame = _counted_call(lambda: render(scene, state))
    assert per_frame["rpt_analytic_nearest"] == 1
    lacking = [smoke.replay_check(torch, render, scene, state, per_frame, f"instances, run {i}")
               for i in range(30)]
    print(f"profiler traces lacking a counted kernel: {sum(map(bool, lacking))} of 30 "
          f"{[x for x in lacking if x]}")


def test_viewer_graph_takes_new_dirs_within_the_pad(cuda, graph_scenes):
    """The viewer's renderer: a resize within the pad copies new dirs into
    the same graph (one capture), each frame equal to build_render_fn's
    uint8 frame of its size."""
    from relativitypathtracer_tpu_torch import render as prender

    scene, meta = graph_scenes["textured"]
    render = prender.build_viewer_render_fn(meta, 128, 192, -1, device=cuda)
    state = _graph_state(cuda, 1)
    for w, h in ((192, 128), (170, 100), (180, 120)):
        got = render(scene, state, prender.viewer_dirs(w, h, 128, 192, device=cuda))
        want = prender.build_render_fn(meta, w, h, -1, out_uint8=True, device=cuda)(scene, state)
        assert torch.equal(got[:h, :w], want)
    assert render.captures == 1


def test_sharded_and_loaded_graphs_equal_the_eager_frame(cuda, graph_scenes):
    """Two logical shards (one graph of the card's shards, the gather eager)
    and the loaded artifact (one graph of the loaded program): frames at
    two states equal the eager live frame to the bit; the shards' replay
    counts 2x an eager frame's launches."""
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn
    from relativitypathtracer_tpu_torch.utils import aot

    scene, meta = graph_scenes["instances"]
    sharded = build_sharded_render_fn(meta, 160, 96, -1, [cuda] * 2, with_aux=True)
    loaded = aot.load_render(aot.export_render(scene, meta, 160, 96, device=cuda))
    for i in (1, 2):
        st = _graph_state(cuda, i)
        (want, waux), eager_launches = _counted_call(
            lambda: _eager_frame(meta, scene, st, 160, 96, cuda))
        (img, aux), launches = _counted_call(lambda: sharded(scene, st))
        assert torch.equal(img, want) and _aux(aux) == _aux(waux)
        if i == 2:
            assert launches == {k: 2 * n for k, n in eager_launches.items()}
        assert torch.equal(loaded(scene, st), want)
    assert [p.captures for p in sharded.parts] == [1] and loaded.captures == 1


def test_cached_renderers_share_one_graph_pool(cuda, graph_scenes):
    """Nine cached renderers of one frame size (nine intervals) on one card:
    their graphs draw their intermediates from the card's one pool, so each
    of the eight after the first reserves on average less than half of one
    eager frame's peak memory (a pool of its own would hold a frame's
    intermediates, about that peak); every frame, rendered again after all
    the others replayed, equals its first rendering and the eager frame."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender

    scene, meta = graph_scenes["textured"]
    state = _graph_state(cuda, 1)
    consts = prender.render_constants(meta, 1024, 768, 1, cuda)

    def eager(interval):
        with prender.full_precision():
            return prender.trace_frame(scene, meta, state, *consts, interval, 1024, 768)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    eager(-1)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(cuda) - base
    torch.cuda.empty_cache()
    renders, frames, reserved = [], [], []
    for interval in range(-1, 8):
        render = pt.build_render_fn(meta, 1024, 768, interval, device=cuda)
        render(scene, state)
        frames.append(render(scene, state))
        renders.append(render)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert (reserved[-1] - reserved[0]) / 8 < eager_peak / 2, \
        f"reserved MiB {[r / 2**20 for r in reserved]}, eager peak {eager_peak / 2**20} MiB"
    for interval, render, kept in reversed(list(zip(range(-1, 8), renders, frames))):
        assert torch.equal(render(scene, state), kept) and torch.equal(kept, eager(interval))
    assert all(r.captures == 1 for r in renders)


def test_sharded_export_on_distinct_cards(cuda, graph_scenes):
    """The sharded renderer and its artifact over every card of a host with
    two or more (a graph a card, the gather eager on the first): frames
    equal to the single card's to the bit."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.parallel.tiles import (build_sharded_render_fn,
                                                               default_devices)
    from relativitypathtracer_tpu_torch.utils import aot

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = default_devices()
    scene, meta = graph_scenes["instances"]
    single = pt.build_render_fn(meta, 160, 96, -1, device=cuda)
    live = build_sharded_render_fn(meta, 160, 96, -1, cards)
    loaded = aot.load_render(aot.export_sharded_render(scene, meta, 160, 96, cards, -1))
    assert len(loaded.parts) == len(cards)
    for i in (1, 2):
        st = _graph_state(cuda, i)
        want = single(scene, st)
        assert torch.equal(live(scene, st), want) and torch.equal(loaded(scene, st), want)
    assert [p.captures for p in loaded.parts] == [1] * len(cards)


def test_two_cached_renderers_replay_in_turns_on_one_stream(cuda, graph_scenes):
    """The one-pool rule's supported use: two cached renderers (textured and
    cubes) of one card, whose graphs share the card's pool, replayed
    alternately 10 times each from one thread on one stream; every frame
    equals its renderer's eager frame to the bit, counts alike."""
    import relativitypathtracer_tpu_torch as pt

    state = _graph_state(cuda, 2)
    pairs = []
    for kind in ("textured", "cubes"):
        scene, meta = graph_scenes[kind]
        render = pt.build_render_fn(meta, 160, 96, -1, with_aux=True, device=cuda)
        pairs.append((render, scene, _eager_frame(meta, scene, state, 160, 96, cuda)))
    for _ in range(10):
        for render, scene, (want, waux) in pairs:
            img, aux = render(scene, state)
            assert torch.equal(img, want) and _aux(aux) == _aux(waux)
    assert all(render.captures == 1 for render, _, _ in pairs)


def test_index_less_cuda_renderer_stays_on_its_card(cuda, tmp_path):
    """A renderer built for "cuda" while card 1 is current stays on card 1:
    its constants, its graph's static inputs and its frame, also when card 0
    is current at a later call (device.resolve at build)."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    host = pt.load_scene_file(write_demo_scene(str(tmp_path), 3, "textured"))
    card1 = torch.device("cuda", 1)
    previous = torch.cuda.current_device()
    try:
        torch.cuda.set_device(1)
        scene, meta = pt.build_scene(host, device="cuda")
        state = pt.FrameState(torch.tensor([0.3, 0.0, 0.1], device="cuda"),
                              torch.tensor([0.05, 0.0, 0.0, 0.0], device="cuda"))
        render = pt.build_render_fn(meta, 160, 96, -1, with_aux=True, device="cuda")
        assert render.device == card1
        first = render(scene, state)
        torch.cuda.set_device(0)
        again = render(scene, state)
        for img, aux in (first, again):
            assert img.device == card1 and all(v.device == card1 for v in aux.values())
        frame = next(iter(render.graphs.values()))
        assert all(x.device == card1 for x in frame.statics)
        assert torch.equal(first[0], again[0])
        torch.cuda.set_device(1)
        viewer = prender.build_viewer_render_fn(meta, 96, 160, -1, device="cuda")
        dirs = prender.viewer_dirs(160, 96, 96, 160, device=card1)
        torch.cuda.set_device(0)
        assert viewer.device == card1 and viewer(scene, state, dirs).device == card1
    finally:
        torch.cuda.set_device(previous)
