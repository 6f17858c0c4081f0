"""K4, the live-chunk list build, against the JAX package on the CPU.

The port builds every list from one table of culling cones
(`mesh_kernels.cone_table`, twin `cone_table_plain`), a cull (`live_cull`,
twin `live_cull_plain`) and a counting sort (`bucket_order`, twin
`bucket_order_plain`). Here, on CPU tensors, the wrappers take the twins:
- the cone table against the JAX package's `_cones_of` after
  `_mask_invalid_lanes`, at 128-lane sub-cones and 1024-lane block cones:
  within 1e-6 (the twin's means are pairwise trees, XLA's reductions run in
  its own order); the twin's tree equal to a float32 recursive halving and
  within its error bound of float64; the pool's glue (lane bound in each
  object's units, enabled column, smin) equal to the per-op composition it
  replaced; strided and stride-0 rays equal to their contiguous copies;
- the lists against the JAX `live_chunk_lists`, `live_chunk_lists2` (S = 32,
  a ragged chunk count), `live_chunk_lists3` (S = 128) and
  `live_chunk_lists_multi` (a disabled object, a shared-unit lane bound,
  all-masked sub-cones), at the existing list tests' tolerances: counts,
  live sets and bits equal, at most 1% of live entries in another place
  (a 1-ulp difference of a cone reduction may move an entry across a bucket
  edge), floors within 1e-6; the two-level orders equal;
- the pool's batched table and cull equal (torch.equal) to the per-object
  loop they replace, and the cull's superchunk variant equal to the flat
  cull reduced by hand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import list_rays as _rays
from torch_port_fixtures import list_spheres as _spheres
from torch_port_fixtures import t

from relativitypathtracer_tpu.ops.pallas import mesh_batch as jmb
from relativitypathtracer_tpu.ops.pallas import mesh_kernels as jmk
from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as pmb
from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as pmk

N_PAD = 2048  # list_rays' default: two 1024-lane blocks
COUNTS = (20, 13, 27)  # chunks per pool object: 60 in all, none a multiple of 32


def _assert_lists_close(po, pmn, pc, jo, jmn, jc):
    """The flat lists' tolerance (test_live_chunk_lists_match_jax)."""
    assert np.array_equal(pc, jc) and jc.sum() > 0
    live = np.arange(jo.shape[1])[None, :] < jc[:, None]
    for b in range(jo.shape[0]):
        assert set(po[b, live[b]]) == set(jo[b, live[b]])
    assert np.mean(po[live] != jo[live]) <= 0.01
    rows = np.arange(jo.shape[0])[:, None]
    np.testing.assert_allclose(pmn[rows, po][live], jmn[rows, jo][live], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lanes", [128, 1024])
@pytest.mark.parametrize("masked", [False, True], ids=["all_lanes", "masked"])
def test_cone_table_matches_jax(lanes, masked):
    """The twin (cone_table on CPU tensors): apex, axis, cos_a, o_rad within
    1e-6 of the JAX cones; sin_a from cos_a; has_valid where a group keeps a
    lane; bound the group's max lane bound; enabled 1."""
    torch.set_num_threads(1)
    d, o, valid, bound = _rays(np.random.default_rng(1), shadow=True)
    jd, jo_ = jnp.asarray(d).reshape(3, -1, lanes), jnp.asarray(o).reshape(3, -1, lanes)
    if masked:
        jd, jo_ = jmk._mask_invalid_lanes(jd, jo_, jnp.asarray(valid))
    want = [np.asarray(x) for x in jmk._cones_of(jd, jo_)]
    tab = pmk.cone_table(t(d), t(o), t(valid) if masked else None, t(bound), lanes=lanes).numpy()
    assert tab.shape == (N_PAD // lanes, pmk.CONE_COLS)
    for got, w in zip((tab[:, 0:3].T, tab[:, 3:6].T, tab[:, 6], tab[:, 8]), want):
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tab[:, 7], np.sqrt(np.maximum(
        np.float32(1.0) - tab[:, 6] * tab[:, 6], np.float32(0.0))))
    has = valid.reshape(-1, lanes).any(axis=1) if masked else np.ones(N_PAD // lanes, bool)
    np.testing.assert_array_equal(tab[:, 10], has.astype(np.float32))
    assert (masked and lanes == 128) == (not tab[:, 10].all())  # two all-masked sub-cones
    np.testing.assert_array_equal(tab[:, 9], bound.reshape(-1, lanes).max(axis=1))
    assert (tab[:, 11] == 1.0).all()


def _halves_f32(x):
    """float32 sum of a power-of-two run by recursive halving, in numpy."""
    if x.shape[-1] == 1:
        return x[..., 0]
    h = x.shape[-1] // 2
    return (_halves_f32(x[..., :h]) + _halves_f32(x[..., h:])).astype(np.float32)


@pytest.mark.parametrize("lanes", [128, 1024])
def test_tree_sum_is_pairwise_and_within_its_error_bound(lanes):
    """The twin's means are pairwise trees: `_tree_sum` equals a float32
    recursive halving to the bit, and is within log2(lanes) rounding units
    of sum |x| of the float64 sum (the pairwise bound), on rows of mixed
    signs and magnitudes 1e-3 to 1e3; the cone table's apex is that sum
    over the lanes count."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(64, lanes)) * np.exp(rng.uniform(-7, 7, (64, lanes)))).astype(
        np.float32)
    got = pmk._tree_sum(t(x)).numpy()
    assert np.array_equal(got.view(np.int32), _halves_f32(x).view(np.int32))
    exact = x.astype(np.float64).sum(axis=1)
    bound = np.log2(lanes) * 2.0 ** -24 * np.abs(x).astype(np.float64).sum(axis=1)
    assert np.all(np.abs(got - exact) <= bound * (1 + 1e-6))
    o = np.repeat(x[:3, None, :], 1, axis=1).reshape(3, lanes)
    rows = pmk.cone_table_plain(t(o), t(o), lanes=lanes).numpy()
    assert np.array_equal(rows[0, 0:3], (got[:3] / np.float32(lanes)).astype(np.float32))


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_pool_glue_equals_the_composition_it_replaced(shadow):
    """The pool's table in one call (cone_table_plain with s and enabled)
    equal (torch.equal) to the ops it replaced: the table of the lane bound
    divided by clamp(s, 1e-12), the enabled column zeroed for a disabled
    object by a host loop, and smin the min of where(valid, s, INF) over
    each block; the shadow case with object 1 disabled, two all-masked
    sub-cones, an all-masked block (smin INF), a zero scale and a NaN and an
    INF lane bound."""
    torch.set_num_threads(1)
    spheres, d_os, o_os, s_os, extra = _pool_inputs(12, shadow)
    d_os, o_os, s_os = t(d_os), t(o_os), t(s_os)
    valid = lbs = None
    enabled = (True, True, True)
    if shadow:
        valid, lbs, enabled = t(extra["valid"]), t(extra["lane_bound_shared"]), extra["enabled"]
        valid[1024:2048] = False
        s_os[2, 5] = 0.0
        lbs[7], lbs[300] = float("nan"), float("inf")
    en = torch.tensor([int(e) for e in enabled], dtype=torch.int32)
    rows, smin = pmk.cone_table_plain(d_os, o_os, valid, lbs, pmk.SUB_LANES, s_os, en)
    lb = None if lbs is None else lbs / torch.clamp(s_os, min=1e-12)
    want = pmk.cone_table_plain(d_os, o_os, valid, lb)
    for g, on in enumerate(enabled):
        if not on:
            want[g, :, pmk.CONE_COLS - 1] = 0.0
    s = s_os if valid is None else torch.where(valid, s_os, pmk.INF)
    want_smin = s.reshape(len(COUNTS), N_PAD // pmk.NB, pmk.NB).amin(dim=2)
    assert torch.equal(rows.view(torch.int32), want.view(torch.int32))
    assert torch.equal(smin, want_smin)
    if shadow:
        assert bool(torch.isnan(rows[:, 0, 9]).all()) and bool(torch.isinf(rows[:, 2, 9]).all())
        assert rows[1, :, 11].tolist() == [0.0] * 16 and bool((rows[0, :, 11] == 1).all())
        assert bool((smin[:, 1] == pmk.INF).all()) and not bool(rows[:, 8:16, 10].any())


def test_cone_table_reads_strided_rays_as_their_copies():
    """Rays as the list builds pass them: a stride-0 origin (the shared
    origin expanded over the lanes), rows 0-2 and 6-8 of a (10, n) array,
    every other lane of wider arrays (rays and lane bound), and a pool's stride-0 origins
    (O, 3, 1) expanded: each table equal to the table of contiguous
    copies, to the bit."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(13)
    d, o, valid, bound = _rays(rng, shadow=True)
    ro = t(rng.uniform(-0.2, 0.2, 3).astype(np.float32))
    r10 = t(rng.normal(size=(10, N_PAD)).astype(np.float32))
    wide = t(rng.normal(size=(2, 3, 2 * N_PAD)).astype(np.float32))
    cases = [(t(d), ro[:, None].expand(3, N_PAD), None, None),
             (r10[0:3], r10[6:9], t(valid), t(bound)),
             (wide[0, :, ::2], wide[1, :, 1::2], t(valid), t(np.repeat(bound, 2))[::2]),
             (t(np.stack([d, d])), torch.stack([ro, -ro])[:, :, None].expand(2, 3, N_PAD),
              None, None)]
    for dd, oo, v, b in cases:
        for lanes in (128, 1024):
            got = pmk.cone_table(dd, oo, v, b, lanes)
            want = pmk.cone_table(dd.contiguous(), oo.contiguous(), v,
                                  None if b is None else b.contiguous(), lanes)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cone_table_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches rpt_cone_table or raises, before
    any build or launch: meta tensors are not on a CUDA device; lanes other
    than 128 and 1024, and n_pad not a multiple of 1024, raise too."""

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA device"):
        pmk.cone_table(m(3, 2048), m(3, 2048))
    with pytest.raises(ValueError, match="CUDA device"):
        pmk.cone_table(m(2, 3, 2048), m(2, 3, 2048), m(2048, dtype=torch.bool), m(2048),
                       128, m(2, 2048), m(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lanes"):
        pmk.cone_table(m(3, 2048), m(3, 2048), lanes=256)
    with pytest.raises(ValueError, match="multiple of 1024"):
        pmk.cone_table(m(3, 1536), m(3, 1536))


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_flat_lists_match_jax(shadow):
    spheres = _spheres(np.random.default_rng(2), 45)
    d, o, valid, bound = _rays(np.random.default_rng(3), shadow=shadow)
    kw = dict(valid=valid, lane_bound=bound) if shadow else {}
    jo, jmn, jc = (np.asarray(x) for x in jmk.live_chunk_lists(
        jnp.asarray(spheres), jnp.asarray(d), jnp.asarray(o),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    po, pmn, pc = (x.numpy() for x in pmk.live_chunk_lists(
        t(spheres), t(d), t(o), **{k: t(v) for k, v in kw.items()}))
    _assert_lists_close(po, pmn, pc, jo[:, 0], jmn[:, 0], jc[:, 0, 0])


@pytest.mark.parametrize("lists_fn,s,C", [("live_chunk_lists2", 32, 77),
                                          ("live_chunk_lists3", 128, 300)])
def test_two_level_lists_match_jax_at_path_widths(lists_fn, s, C):
    """lists2 at the large path's S = 32 on a ragged 77 chunks (a last bit
    word and super of 13), lists3 at S = 128 on 300 chunks (a last super of
    44): orders, counts and bits equal, floors within 1e-6, with masked
    lanes (two all-masked sub-cones) and a lane bound."""
    spheres = _spheres(np.random.default_rng(4), C)
    d, o, valid, bound = _rays(np.random.default_rng(5), shadow=True)
    args = [jnp.asarray(x) for x in (spheres, d, o, valid, bound)]
    jo, jmn, jc, jb = (np.asarray(x) for x in getattr(jmk, lists_fn)(*args, s=s))
    po, pmn, pc, pb = (x.numpy() for x in getattr(pmk, lists_fn)(
        *[t(x) for x in (spheres, d, o, valid, bound)], s=s))
    jo, jmn, jc, jb = jo[:, 0], jmn[:, 0], jc[:, 0, 0], jb[:, 0]
    assert pc.sum() > 0 and np.array_equal(pc, jc) and np.array_equal(pb, jb)
    assert pb.shape[1] == (-(-C // 32) if s == 32 else -(-C // s) * s // 32)
    live = np.arange(jo.shape[1])[None, :] < jc[:, None]
    assert np.array_equal(po[live], jo[live])
    np.testing.assert_allclose(pmn[live], jmn[live], rtol=1e-6, atol=1e-6)


def _pool_inputs(seed, shadow):
    """Three objects' spheres, per-object dirs, origins and scales, valid,
    a shared-unit lane bound and enabled (object 1 off) for shadow rays;
    numpy."""
    rng = np.random.default_rng(seed)
    spheres = _spheres(rng, sum(COUNTS))
    d_os, o_os = [], []
    for _ in COUNTS:
        d, o, valid, bound = _rays(rng, shadow=shadow)
        d_os.append(d)
        o_os.append(o)
    s_os = rng.uniform(0.5, 2.0, (len(COUNTS), N_PAD)).astype(np.float32)
    _, _, valid, bound = _rays(rng, shadow=True)
    extra = dict(valid=valid, enabled=(True, False, True), lane_bound_shared=bound) if shadow \
        else {}
    return spheres, np.stack(d_os), np.stack(o_os), s_os, extra


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_pool_lists_match_jax(shadow):
    """live_chunk_lists_multi on three objects; the shadow case with object
    1 disabled, a shared-unit lane bound and two all-masked sub-cones."""
    spheres, d_os, o_os, s_os, extra = _pool_inputs(6, shadow)
    jo, jmn, jc = (np.asarray(x) for x in jmb.live_chunk_lists_multi(
        jnp.asarray(spheres), COUNTS, jnp.asarray(d_os), jnp.asarray(o_os), jnp.asarray(s_os),
        **{k: v if k == "enabled" else jnp.asarray(v) for k, v in extra.items()}))
    po, pmn, pc = (x.numpy() for x in pmb.live_chunk_lists_multi(
        t(spheres), COUNTS, t(d_os), t(o_os), t(s_os),
        **{k: v if k == "enabled" else t(v) for k, v in extra.items()}))
    _assert_lists_close(po, pmn, pc, jo[:, 0], jmn[:, 0], jc[:, 0, 0])
    if shadow:  # the disabled object's chunks: never live, INF floors before the sort
        dead = np.arange(COUNTS[0], COUNTS[0] + COUNTS[1])
        live = np.arange(po.shape[1])[None, :] < pc[:, None]
        assert not np.isin(po[live], dead).any()


def _pool_by_object(spheres, chunk_counts, d_os, o_os, s_os, valid=None, enabled=None,
                    lane_bound_shared=None):
    """The per-object loop that the batched pool build replaced: each
    object's own cone table and cull, its floors scaled by the block's
    minimum scale, a disabled object's chunks INF and dead, concatenated,
    then sorted."""
    B = d_os.shape[2] // pmk.NB
    minds, overlaps, c0 = [], [], 0
    for g, nck in enumerate(chunk_counts):
        if enabled is not None and not enabled[g]:
            minds.append(torch.full((B, nck), pmk.INF))
            overlaps.append(torch.zeros((B, nck), dtype=torch.bool))
            c0 += nck
            continue
        s = s_os[g].reshape(B, pmk.NB)
        if valid is not None:
            s = torch.where(valid.reshape(B, pmk.NB), s, pmk.INF)
        lb = None
        if lane_bound_shared is not None:
            lb = lane_bound_shared / torch.clamp(s_os[g], min=1e-12)
        table = pmk.cone_table(d_os[g], o_os[g], valid, lb)
        mind_g, over_g = pmk.live_cull_plain(spheres[c0:c0 + nck], table, pmk.SUB,
                                             lb is not None)
        c0 += nck
        minds.append(mind_g * s.amin(dim=1, keepdim=True))
        overlaps.append(over_g)
    return pmk.bucket_order_plain(torch.cat(minds, dim=1), torch.cat(overlaps, dim=1))


@pytest.mark.parametrize("shadow", [False, True], ids=["shared", "shadow"])
def test_batched_pool_twin_equals_the_per_object_loop(shadow):
    spheres, d_os, o_os, s_os, extra = _pool_inputs(7, shadow)
    args = (t(spheres), COUNTS, t(d_os), t(o_os), t(s_os))
    kw = {k: v if k == "enabled" else t(v) for k, v in extra.items()}
    got = pmb.live_chunk_lists_multi_plain(*args, **kw)
    want = _pool_by_object(*args, **kw)
    assert int(want[2].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(pmb.live_chunk_lists_multi(*args, **kw), got):  # CPU: the twin
        assert torch.equal(g, w)


@pytest.mark.parametrize("s", [4, 32, 128])
def test_super_cull_equals_the_flat_cull_reduced(s):
    """live_cull_plain's superchunk variant: the flat cull's overlap packed
    (pack_bits) and its floors and overlap reduced over groups of s chunks
    with INF / dead padding, on a ragged 77 chunks; without floors, the bits
    alone."""
    spheres = t(_spheres(np.random.default_rng(8), 77))
    d, o, valid, bound = _rays(np.random.default_rng(9), spread=0.05)
    table = pmk.cone_table(t(d), t(o), t(valid), t(bound))
    mind, over = pmk.live_cull(spheres, table, pmk.SUB, True)
    C_s, n_words = -(-77 // s), -(-77 // 32)
    bits, mg, og = pmk.live_cull(spheres, table, pmk.SUB, True, None, None, s, n_words)
    assert torch.equal(bits, pmk.pack_bits(over))
    pad = C_s * s - 77
    want_m = torch.cat([mind, torch.full((mind.shape[0], pad), pmk.INF)], dim=1)
    want_o = torch.cat([over, torch.zeros((over.shape[0], pad), dtype=torch.bool)], dim=1)
    assert torch.equal(mg, want_m.reshape(-1, C_s, s).amin(dim=2))
    assert torch.equal(og, want_o.reshape(-1, C_s, s).any(dim=2))
    assert bool(og.any()) and not bool(over.all())
    alone = pmk.live_cull(spheres, table, pmk.SUB, True, None, None, s, n_words, False)
    assert torch.equal(alone[0], bits) and alone[1] is None and alone[2] is None


def test_bucket_order_keeps_ties_and_empty_blocks():
    """The twin's counting sort: a block of equal floors in entry-id order,
    a block with nothing live (hi = -INF, span clamped to 1e-6: every entry
    dead, in id order, count 0), and a block whose live entries share one
    bucket with dead ones before them."""
    mind = torch.tensor([[1.0] * 6, [0.5, 0.1, 0.3, 0.2, 0.9, 0.4], [2.0, 1.0, 1.0, 3.0, 1.0, 1.0]])
    over = torch.tensor([[True] * 6, [False] * 6, [False, False, True, True, False, True]])
    order, key, counts = pmk.bucket_order(mind, over)
    assert counts.tolist() == [6, 0, 3]
    assert order[0].tolist() == [0, 1, 2, 3, 4, 5]
    assert order[1].tolist() == [0, 1, 2, 3, 4, 5]
    assert order[2].tolist() == [2, 5, 3, 0, 1, 4]
    assert torch.equal(key[0], mind[0])


# --- the cull kernel's group pre-test --------------------------------------------

PRETEST_CASES = ("tangent", "apex_inside", "wrap", "bound_edge", "has_valid_0", "nan_sphere",
                 "ragged", "scales")
N_PAIRS = 100_000  # (cone, group) pairs a case


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ulps(x, k):
    """float32 x moved by k (an int array) ulps."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.int32) + np.where(x >= 0, k, -k).astype(np.int32)
    return bits.view(np.float32)


def _adversarial_pairs(rng, case, n):
    """n cones and n groups of 32 chunk spheres, group i placed against cone
    i: (spheres (32 n, 4), table (n, 1, CONE_COLS), use_bound), numpy
    float32. Each group's base sphere (radius r, the cone's o_rad o) lies at
    distance D from the apex at the angle a + asin((r + o) / D) + delta from
    the axis: tangent to the cone, delta a few ulps of the angle either
    side, or spread over three times the pre-test's angular margin. A third
    of the groups repeat the base sphere 32 times, a third jitter it by ulps,
    a third hold it and 31 small spheres inside it."""
    big = case == "scales"
    apex = rng.uniform(-5.0, 5.0, (n, 3))
    axis = _unit(rng, n)
    if case == "wrap":  # cos_a < 0: a + b reaches pi
        a = rng.uniform(np.pi / 2 + 0.01, np.pi - 1e-3, n)
    else:
        a = np.exp(rng.uniform(np.log(1e-4), np.log(1.2), n))
    D = np.exp(rng.uniform(np.log(1e-3 if big else 0.5), np.log(1e3 if big else 50.0), n))
    r = np.exp(rng.uniform(np.log(1e-4 if big else 1e-3), np.log(1e2 if big else 1.0), n))
    o = np.where(rng.uniform(size=n) < 0.5, 0.0, np.exp(rng.uniform(np.log(1e-4), 0.0, n)) * r)
    kappa = pmk.GROUP_KAPPA
    delta = np.where(rng.uniform(size=n) < 0.5,
                     rng.integers(-6, 7, n) * 2.0 ** -23 * np.maximum(a, 1.0),
                     rng.uniform(-3 * kappa, 3 * kappa, n))
    theta = a + np.arcsin(np.minimum((r + o) / D, 1.0)) + delta
    if case == "wrap":  # behind the apex, or tangent to the wrapped cap
        theta = np.where(rng.uniform(size=n) < 0.5, np.pi, np.minimum(theta, np.pi))
        sin_b = np.sin(np.pi - a + delta * rng.integers(0, 2, n))
        D = np.where(sin_b > 1e-3, (r + o) / np.maximum(sin_b, 1e-3), D)
    if case == "bound_edge":
        theta = np.where(rng.uniform(size=n) < 0.5, 0.0, theta)
    perp = _unit(rng, n)
    perp -= (perp * axis).sum(1, keepdims=True) * axis
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    centre = apex + D[:, None] * (np.cos(theta)[:, None] * axis + np.sin(theta)[:, None] * perp)
    if case == "apex_inside":
        centre = apex + _unit(rng, n) * (r * rng.uniform(0.0, 1.0 + 1e-6, n))[:, None]
    sph = np.repeat(np.concatenate([centre, r[:, None]], axis=1)[:, None], 32, axis=1)
    kind = np.arange(n) % 3
    jit = kind == 1
    sph[jit, :, :3] += rng.integers(-4, 5, (int(jit.sum()), 32, 3)) * 2.0 ** -23 * np.abs(
        sph[jit, :, :3])
    sph[jit, :, 3] *= 1.0 + rng.integers(-4, 5, (int(jit.sum()), 32)) * 2.0 ** -23
    inner = kind == 2
    sph[inner, 1:, :3] += (_unit(rng, int(inner.sum()) * 31).reshape(-1, 31, 3)
                           * (0.5 * r[inner])[:, None, None])
    sph[inner, 1:, 3] = 0.25 * r[inner][:, None]
    spheres = sph.reshape(32 * n, 4).astype(np.float32)
    if case == "nan_sphere":
        spheres[32 * np.arange(0, n, 2) + rng.integers(0, 32, (n + 1) // 2), 0] = np.nan
        spheres[32 * np.arange(1, n, 4) + 7, 3] = np.inf
    axis32 = axis.astype(np.float32)
    cos_a = np.cos(a).astype(np.float32)
    sin_a = np.sqrt(np.maximum(np.float32(1.0) - cos_a * cos_a, np.float32(0.0)))
    bound = np.zeros(n, np.float32)
    if case == "bound_edge":  # mind at bound + 1e-3 within a few ulps, or the pre-test's margin
        edge = (D - r - o - 1e-3).astype(np.float32)
        bound = np.where(rng.uniform(size=n) < 0.5, _ulps(edge, rng.integers(-8, 9, n)),
                         edge * (1.0 - rng.integers(-4, 5, n) * pmk.GROUP_MU)).astype(np.float32)
    has_valid = np.ones(n, np.float32)
    if case == "has_valid_0":
        has_valid[rng.uniform(size=n) < 0.5] = 0.0
    table = np.concatenate([apex.astype(np.float32), axis32, cos_a[:, None], sin_a[:, None],
                            o.astype(np.float32)[:, None], bound[:, None], has_valid[:, None],
                            np.ones((n, 1), np.float32)], axis=1)
    return spheres, table[:, None, :], case == "bound_edge"


def _pretest_against_dense(spheres, table, sub, use_bound, cobj=None):
    """(may (B, G), live (B, G)): the pre-test's verdicts and whether the
    twin's dense tests find any chunk of the group live."""
    may = pmk.group_may_overlap_plain(spheres, table, sub, use_bound, cobj)
    _, over = pmk.live_cull_plain(spheres, table, sub, use_bound, cobj)
    B, C = over.shape
    G = may.shape[1]
    live = torch.cat([over, over.new_zeros((B, G * 32 - C))], dim=1).reshape(B, G, 32).any(2)
    return may, live


@pytest.mark.parametrize("case", PRETEST_CASES)
def test_group_pretest_dead_implies_every_chunk_dead(case):
    """The cull kernel's pre-test is sound: wherever it calls a (cone,
    group) pair dead, every cone test of the group's chunks is false in
    live_cull_plain's own float32 arithmetic. 10^5 pairs a case, each group
    placed against its cone: tangent to the cone within a few ulps or
    around the pre-test's margin; the apex inside a chunk; a + b at pi
    (cos_a < 0); mind at bound + 1e-3 within a few ulps; has_valid 0 on
    half the cones; a NaN sphere in every other group (and an infinite
    radius in some), which never lets a group die; a ragged last group
    against 3,125 cones; radii 1e-4 to 1e2 at distances 1e-3 to 1e3."""
    rng = np.random.default_rng(500 + PRETEST_CASES.index(case))
    if case == "ragged":  # 32 groups, the last of 19 chunks, against every cone
        spheres, table, _ = _adversarial_pairs(rng, "tangent", 3125)
        spheres = spheres[32 * rng.integers(0, 3125, 32)[:, None] + np.arange(32)].reshape(-1, 4)
        may, live = _pretest_against_dense(t(spheres[:1011]), t(table[:, 0]), 1, False)
        assert may.shape == (3125, 32)
    else:
        spheres, table, use_bound = _adversarial_pairs(rng, case, N_PAIRS)
        cobj = t(np.repeat(np.arange(N_PAIRS, dtype=np.int32), 32))
        may, live = _pretest_against_dense(t(spheres), t(table), 1, use_bound, cobj)
        may, live = may[0], live[0]  # one "block" of one cone per object
    assert may.numel() >= N_PAIRS
    assert not bool((live & ~may).any()), f"{int((live & ~may).sum())} live groups called dead"
    dead = int((~may).sum())
    if case == "has_valid_0":
        off = t(table[:, 0, 10]) == 0
        assert bool((~may)[off].all()) and not bool(live[off].any()) and bool(live.any())
    elif case == "apex_inside":
        assert dead == 0 and bool(live.all())
    elif case == "nan_sphere":
        assert not bool((~may)[0::2].any())  # a NaN in the group: never dead
        assert 0 < dead and bool(live.any())
    else:  # the test bites: some pairs are dead, some live
        assert 0 < dead < may.numel() and bool(live.any())


def test_group_pretest_on_the_large_fixture(tmp_path_factory):
    """On the `large` fixture's first frame at 64x64 (10,240 chunks, its
    primary and shadow cull), the pre-test never calls a live group dead and
    proves a share of the groups dead."""
    import relativitypathtracer_tpu_torch as pt
    from torch_port_fixtures import write_fixture

    host = pt.load_scene_file(write_fixture(tmp_path_factory, 3, "large"))
    scene, meta = pt.build_scene(host, device="cpu")
    calls, real = [], pmk.live_cull
    pmk.live_cull = lambda *a, **kw: calls.append(a) or real(*a, **kw)
    try:
        pt.build_render_fn(meta, 64, 64, -1, device="cpu")(
            scene, pt.FrameState(torch.zeros(3), torch.zeros(4)))
    finally:
        pmk.live_cull = real
    assert [a[0].shape[0] for a in calls] == [10240, 10240]
    for spheres, table, sub, use_bound, *_ in calls:
        may, live = _pretest_against_dense(spheres, table, sub, use_bound)
        assert not bool((live & ~may).any()) and bool(live.any())
        assert int((~may).sum()) >= 0.2 * may.numel()
