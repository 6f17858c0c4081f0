"""K4, the live-chunk list build, against the JAX package on the CPU.

The port builds every list from one table of culling cones
(`mesh_kernels.cone_table`, torch code shared by the CUDA kernels and their
twins), a cull (`live_cull`, twin `live_cull_plain`) and a counting sort
(`bucket_order`, twin `bucket_order_plain`). Here, on CPU tensors, the
wrappers take the twins:
- the cone table against the JAX package's `_cones_of` after
  `_mask_invalid_lanes`, at 128-lane sub-cones and 1024-lane block cones:
  within 1e-6 (the same reductions, in torch's and XLA's order);
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
    """apex, axis, cos_a, o_rad within 1e-6 of the JAX cones; sin_a from
    cos_a; has_valid where a group keeps a lane; bound the group's max lane
    bound; enabled 1."""
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
