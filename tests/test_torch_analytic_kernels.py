"""The port's K3 (analytic nearest hit) against the JAX package's Pallas
kernel in interpret mode.

With 5 or more objects of a kind the JAX kernel walks per-block culled live
lists in bucket-floor order; the port walks every object in id order. The
two agree except at exact ties of t (object ids may then differ, at most
0.1% of lanes).

Tolerances. XLA on the CPU contracts a * b + c into one FMA (about a quarter
of such products then differ by an ulp); the port rounds twice, as the card
does under -fmad=false. Near-grazing hits magnify that ulp, and so does the
cancellation in a far object's object-space hit point. So: t within rtol
1e-5, normal and uv within 1e-5 (the port forms the spherical UVs itself),
on 99% (t) and 95% (normal, uv) of the hit lanes, all within 2e-4; and the
port's 99th-percentile error against a float64 evaluation of the same walk
is at most twice the JAX kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import (PRETEST_CASES, assert_mostly_close, pretest_inputs, t,
                                 tie_flip_frac)

from relativitypathtracer_tpu.ops import relmath as jrel
from relativitypathtracer_tpu.ops.pallas import analytic_kernels as jak
from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as pak


def _frame_inputs(rng, n_spheres, n_cubes, interval):
    """Objects in front of the camera, some moving; their frame matrices as
    the renderer forms them; camera 4-dirs (interval, unit dir)."""
    G = n_spheres + n_cubes
    L, inv_m, stat = [], [], []
    for g in range(G):
        pos = np.array([rng.uniform(-2.0, 2.0), rng.uniform(-1.5, 1.5),
                        rng.uniform(3.0, 7.0)], np.float32)
        m = jrel.trs(pos, np.float32(rng.uniform(0, 3)), rng.normal(size=3).astype(np.float32),
                     rng.uniform(0.5, 1.2, 3).astype(np.float32))
        inv_m.append(np.asarray(jrel.inverse4(m)))
        v = (rng.normal(size=3) * 0.2).astype(np.float32) if g % 2 else np.zeros(3, np.float32)
        L.append(np.asarray(jrel.lorentz(v)))
        stat.append(np.zeros(4, np.float32))
    L, inv_m, stat = np.stack(L), np.stack(inv_m), np.stack(stat)
    n = 4096
    d = rng.normal(size=(3, n)).astype(np.float32) * 0.35
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    dir4 = np.concatenate([np.full((1, n), float(interval), np.float32), d])
    return L, inv_m, stat, dir4


@pytest.mark.parametrize("n_spheres,n_cubes,interval", [
    (1, 0, -1),  # the slice: one light sphere
    (6, 2, -1),  # spheres through the JAX culled walk
    (2, 7, 0),  # cubes through the JAX culled walk, interval 0
    (5, 5, -1),  # both kinds culled
], ids=["one_sphere", "spheres_culled", "cubes_culled", "both_culled"])
def test_analytic_nearest_matches_interpret_kernel(n_spheres, n_cubes, interval):
    rng = np.random.default_rng(100 + n_spheres * 10 + n_cubes)
    L, inv_m, stat, dir4 = _frame_inputs(rng, n_spheres, n_cubes, interval)
    ids = tuple(range(n_spheres + n_cubes))
    params = np.asarray(jak.pack_analytic_params(jnp.asarray(L), jnp.asarray(inv_m),
                                                 jnp.asarray(stat), ids))
    pparams = pak.pack_analytic_params(t(L), t(inv_m), t(stat), ids)
    np.testing.assert_allclose(pparams.numpy(), params, rtol=1e-6, atol=1e-6)

    jt, jn, juv, jo = (np.asarray(x) for x in jak.analytic_nearest_shared(
        params, dir4, n_spheres, n_cubes, interval, interpret=True))
    pt_, pn, puv, po = (x.numpy() for x in pak.analytic_nearest_shared(
        t(params), t(dir4), n_spheres, n_cubes))
    hit = jt < 1e19
    assert hit.any() and not hit.all()
    assert np.array_equal(pt_ < 1e19, hit)
    assert tie_flip_frac(po[hit], jo[hit]) <= 1e-3
    same = hit & (po == jo)
    assert_mostly_close(pt_[same], jt[same], 1e-5, 0.01, 2e-4, rel=True)
    assert_mostly_close(pn[:, same], jn[:, same], 1e-5, 0.05, 2e-4)
    assert_mostly_close(puv[:, same], juv[:, same], 1e-5, 0.05, 2e-4)
    assert np.all(po[~hit] == 0) and np.all(pn[:, ~hit] == 0.0)

    # Accuracy against the same walk in float64: the port's typical error is
    # of the JAX kernel's size.
    qt, qn, quv, qo = (x.numpy() for x in pak.analytic_nearest_plain(
        t(params, torch.float64), t(dir4, torch.float64), n_spheres, n_cubes))
    ok = same & (qo == jo)
    for got, want, ref in ((pt_, jt, qt), (pn, jn, qn), (puv, juv, quv)):
        err_port = np.percentile(np.abs(got[..., ok] - ref[..., ok]), 99)
        err_jax = np.percentile(np.abs(want[..., ok] - ref[..., ok]), 99)
        assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)


@pytest.mark.parametrize("n_spheres,n_cubes,interval", [
    (0, 9, -1),  # the cubes fixture's occluders, through the JAX culled walk
    (6, 2, -1),  # spheres culled
    (5, 5, 0),  # both kinds culled, interval 0
    (1, 2, -1),  # below the culling threshold: JAX's plain loops
], ids=["cubes_culled", "spheres_culled", "both_culled", "unculled"])
def test_analytic_min_t_matches_interpret_kernel(n_spheres, n_cubes, interval):
    """K7's twin against analytic_min_t_general(interpret=True) on shadow
    rays with their own origins. The JAX kernel may report any value >=
    tmax where the nearest occluder lies beyond tmax, so the two are held on
    the lit mask (t >= tmax) of the lanes with tmax > 0, and on t where the
    JAX t < tmax: rtol 1e-5 on 99% of those lanes and 1e-3 on all, because
    far and grazing hits are ill-conditioned in fp32 (the JAX kernel's own t
    is off a float64 walk by up to 3.6e-4 here) and XLA contracts FMAs; and
    the port's 99th-percentile error against the float64 walk is at most
    twice the JAX kernel's. Masked lanes (tmax == 0) give INF."""
    rng = np.random.default_rng(200 + n_spheres * 10 + n_cubes)
    L, inv_m, _, _ = _frame_inputs(rng, n_spheres, n_cubes, interval)
    n = 4096
    o = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-2.5, 2.5, n),
                  rng.uniform(-2.5, 2.5, n), rng.uniform(0.0, 9.0, n)]).astype(np.float32)
    tgt = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)])
    d = (tgt - o[1:]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    dir4 = np.concatenate([np.full((1, n), float(interval), np.float32), d])
    tmax = rng.uniform(1.0, 12.0, n).astype(np.float32)
    tmax[rng.uniform(size=n) < 0.2] = 0.0
    ids = tuple(range(n_spheres + n_cubes))
    params = np.asarray(jak.pack_analytic_params_general(jnp.asarray(L), jnp.asarray(inv_m), ids))
    pparams = pak.pack_analytic_params_general(t(L), t(inv_m), ids)
    np.testing.assert_allclose(pparams.numpy(), params, rtol=1e-6, atol=1e-6)

    want = np.asarray(jak.analytic_min_t_general(
        params, o, dir4, n_spheres, n_cubes, interval, tmax=jnp.asarray(tmax), interpret=True))
    got = pak.analytic_min_t_general(t(params), t(o), t(dir4), n_spheres, n_cubes,
                                     t(tmax)).numpy()
    rel = tmax > 0
    assert np.array_equal((got >= tmax)[rel], (want >= tmax)[rel])
    occ = rel & (want < tmax)
    assert 50 < occ.sum() < rel.sum() - 50  # occluded and lit lanes both occur
    assert_mostly_close(got[occ], want[occ], 1e-5, 0.01, 1e-3, rel=True)
    assert np.all(got[~rel] == 1e20)
    ref = pak.analytic_min_t_plain(t(params, torch.float64), t(o, torch.float64),
                                   t(dir4, torch.float64), n_spheres, n_cubes,
                                   t(tmax, torch.float64)).numpy()
    err_port = np.percentile(np.abs(got[occ] - ref[occ]) / ref[occ], 99)
    err_jax = np.percentile(np.abs(want[occ] - ref[occ]) / ref[occ], 99)
    assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)


# --- The kernels' per-lane pre-test (object_may_hit_plain) -----------------
#
# The K3 and K7 kernels skip an object for a warp whose lanes all fail the
# pre-test; that is exact only if "pre-test false" implies that the full
# test (the twin) finds no hit on that lane and object. The cases
# (torch_port_fixtures.pretest_inputs) hold 4 x 10^5 adversarial (lane,
# object) pairs each, rays that cross the boundary of a hit within a few
# ulps.


def _per_object_t(params, dir4, origins4, n_spheres, n_cubes):
    """The twin's t for each object alone: (G, N)."""
    out = []
    for g in range(n_spheres + n_cubes):
        s = int(g < n_spheres)
        if origins4 is None:
            out.append(pak.analytic_nearest_plain(params[g:g + 1], dir4, s, 1 - s)[0])
        else:
            ones = torch.ones(dir4.shape[1])
            out.append(pak.analytic_min_t_plain(params[g:g + 1], origins4, dir4, s, 1 - s, ones))
    return torch.stack(out)


@pytest.mark.parametrize("case", PRETEST_CASES)
@pytest.mark.parametrize("form", ["K3", "K7"])
def test_object_pretest_false_implies_no_hit(form, case):
    """On 10^5 adversarial (lane, object) pairs, a lane the pre-test
    rejects is never one the twin hits: its per-object t is INF. Both
    verdicts occur. For `ragged` (N not a multiple of 32), lanes past N
    vote no in warp_votes_plain."""
    rng = np.random.default_rng(PRETEST_CASES.index(case) + (50 if form == "K7" else 0))
    params, dir4, o4, ns, nc = pretest_inputs(rng, form, case)
    may = pak.object_may_hit_plain(params, dir4, ns, nc, o4)
    t_g = _per_object_t(params, dir4, o4, ns, nc)
    assert may.shape == t_g.shape and may.numel() >= 100_000
    hit = t_g != pak.INF
    assert int((hit & ~may).sum()) == 0, int((hit & ~may).sum())
    assert bool(hit.any()) and bool((~may).any())
    if case == "ragged":
        N = dir4.shape[1]
        assert N % pak.WARP and pak.warp_votes_plain(may) == sum(
            int(may[:, j:j + pak.WARP].any(dim=1).sum()) for j in range(0, N, pak.WARP))


def test_object_pretest_on_the_cubes_fixture(tmp_path_factory):
    """The `cubes` fixture's first frame at 64x64 (K3: 10 objects; K7: 9
    occluders, lanes with tmax > 0): the pre-test rejects no lane the twin
    hits, and proves at least 80% of the (warp, object) pairs dead."""
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from torch_port_fixtures import write_fixture

    host = pt.load_scene_file(write_fixture(tmp_path_factory, 3, "cubes"))
    scene, meta = pt.build_scene(host, device="cpu")
    calls = {}
    real_n, real_m = prender.analytic_nearest_shared, prender.analytic_min_t_general
    prender.analytic_nearest_shared = lambda *a: calls.setdefault("K3", a) and real_n(*a)
    prender.analytic_min_t_general = lambda *a: calls.setdefault("K7", a) and real_m(*a)
    try:
        pt.build_render_fn(meta, 64, 64, -1, device="cpu")(
            scene, pt.FrameState(torch.zeros(3), torch.zeros(4)))
    finally:
        prender.analytic_nearest_shared, prender.analytic_min_t_general = real_n, real_m
    params, dir4, ns, nc = calls["K3"]
    p7, o4, d7, ns7, nc7, tmax = calls["K7"]
    assert (ns + nc, ns7 + nc7) == (10, 9)
    for p, d, o, s, c, act in ((params, dir4, None, ns, nc, torch.ones(4096, dtype=torch.bool)),
                               (p7, d7, o4, ns7, nc7, tmax > 0)):
        may = pak.object_may_hit_plain(p, d, s, c, o) & act
        hit = (_per_object_t(p, d, o, s, c) != pak.INF) & act
        assert not bool((hit & ~may).any()) and bool(hit.any())
        pairs = may.shape[0] * -(-may.shape[1] // pak.WARP)
        assert pak.warp_votes_plain(may) <= 0.2 * pairs, (pak.warp_votes_plain(may), pairs)
