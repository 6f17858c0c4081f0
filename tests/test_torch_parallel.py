"""The sharded renderer (parallel/tiles.py) and the folded MSAA layout of the
port against their single-device counterparts and the JAX package.

The JAX package runs on conftest's 8 virtual CPU devices through its jnp path
(its default on the CPU), the port on the CPU through its plain twins, with
shards given as the same CPU device named several times (logical shards).
Exact: deal_blocks and the MSAA relayouts (on integer-valued data, whose
sample means are exact in any order); the port's msaa-1 sharded frame and its
aux counts against its single-device frame, torch.equal. Under the parity
rule (torch_port_fixtures.assert_frame_parity): the port's sharded frame
against the JAX package's, at msaa 1 and 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import assert_frame_parity, build_both, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.parallel import tiles

STATE = ((0.3, 0.0, 0.0), (0.1, 0.0, 0.0, 0.0))


def _state():
    return pt.FrameState(torch.tensor(STATE[0]), torch.tensor(STATE[1]))


@pytest.fixture(scope="module")
def port_scenes(tmp_path_factory):
    return {kind: pt.build_scene(pt.load_scene_file(write_fixture(tmp_path_factory, 2, kind)),
                                 device="cpu")
            for kind in ("blob", "cubes", "instances")}


@pytest.fixture(scope="module")
def textured_both(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 2, "textured"))


GRIDS = ((1, 1), (2, 3), (3, 4), (4, 6), (5, 8), (6, 4), (7, 9), (8, 8), (3, 16))


@pytest.mark.parametrize("assign", ["strided", "contiguous"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_deal_blocks_matches_jax(n, assign):
    """Equal arrays on every grid the count divides, unequal diagonal
    classes among them (e.g. 3x4 over 8 shards)."""
    from relativitypathtracer_tpu.parallel.tiles import deal_blocks as jdeal

    dealt = 0
    for rows, cols in GRIDS:
        if rows * cols % n:
            continue
        got, want = tiles.deal_blocks(n, rows, cols, assign), jdeal(n, rows, cols, assign)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (rows, cols)
        dealt += 1
    assert dealt >= 3


@pytest.mark.parametrize("args, match", [((3, 2, 2, "strided"), "not divisible"),
                                         ((2, 2, 2, "rows"), "contiguous|strided")],
                         ids=["indivisible", "unknown_assign"])
def test_deal_blocks_errors_match_jax(args, match):
    from relativitypathtracer_tpu.parallel.tiles import deal_blocks as jdeal

    with pytest.raises(ValueError, match=match):
        tiles.deal_blocks(*args)
    with pytest.raises(ValueError, match=match):
        jdeal(*args)


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_msaa_relayouts_match_jax(m):
    from relativitypathtracer_tpu import render as jrender

    ph, pw = 64, 96
    rng = np.random.default_rng(m)
    x = rng.integers(-64, 64, (m * m, ph, pw, 3)).astype(np.float32)
    sw = prender.msaa_swizzle(torch.as_tensor(x), ph, pw, m)
    assert np.array_equal(sw.numpy(), np.asarray(jrender.msaa_swizzle(jnp.asarray(x), ph, pw, m)))
    got = prender.msaa_mean_unswizzle(sw, ph, pw, m)
    want = jrender.msaa_mean_unswizzle(jnp.asarray(sw.numpy()), ph, pw, m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the round trip: samples equal to their pixel come back as the image
    img = rng.integers(-64, 64, (ph, pw, 3)).astype(np.float32)
    same = torch.as_tensor(img)[None].expand(m * m, ph, pw, 3)
    back = prender.msaa_mean_unswizzle(prender.msaa_swizzle(same, ph, pw, m), ph, pw, m)
    assert torch.equal(back, torch.as_tensor(img).reshape(-1, 3).T)
    # the patch unswizzle, as the sharded renderer calls it
    vec = torch.as_tensor(rng.standard_normal((3, ph * pw)).astype(np.float32))
    assert np.array_equal(prender.tile_unswizzle(vec, ph, pw, 32 // m).numpy(),
                          np.asarray(jrender.tile_unswizzle(jnp.asarray(vec.numpy()), ph, pw,
                                                            32 // m)))


CASES = [(kind, 96, 64, n, assign) for kind in ("blob", "cubes", "instances")
         for n in (2, 4) for assign in ("strided", "contiguous")]
CASES += [(kind, 96, 100, 4, "strided") for kind in ("blob", "cubes", "instances")]


@pytest.mark.parametrize("kind, width, height, n, assign", CASES,
                         ids=[f"{k}-{w}x{h}-n{n}-{a}" for k, w, h, n, a in CASES])
def test_sharded_frame_equals_single_device(port_scenes, kind, width, height, n, assign):
    """A ray's result does not depend on the shard that traces it: the msaa-1
    sharded frame and its summed counts equal the single-device renderer's
    (the padded rows of the 96x64 frame on 4 shards, 128 rows against 64,
    look past the scene and add no count)."""
    scene, meta = port_scenes[kind]
    img, aux = tiles.build_sharded_render_fn(meta, width, height, -1, ["cpu"] * n,
                                             with_aux=True, band_assign=assign)(scene, _state())
    want, waux = pt.build_render_fn(meta, width, height, -1, with_aux=True, device="cpu")(
        scene, _state())
    assert img.shape == (height, width, 3) and torch.equal(img, want)
    assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in waux.items()}
    assert int(aux["hits"]) > 0


def test_sharded_renderer_refuses_other_msaa(port_scenes):
    _, meta = port_scenes["blob"]
    for msaa in (3, 32):
        with pytest.raises(ValueError, match="msaa"):
            tiles.build_sharded_render_fn(meta, 64, 64, -1, ["cpu"] * 2, msaa=msaa)


@pytest.mark.parametrize("msaa", [1, 2])
def test_sharded_frame_matches_jax(textured_both, msaa):
    """The port's sharded frame against the JAX package's shard_map renderer
    on default_mesh(4), the same deal, both with the summed counts."""
    from relativitypathtracer_tpu import render as jrender
    from relativitypathtracer_tpu.parallel.tiles import build_sharded_render_fn, default_mesh

    (js, jm), (ps, pm) = textured_both
    jimg, jaux = build_sharded_render_fn(jm, 64, 64, -1, default_mesh(4), msaa=msaa,
                                         with_aux=True)(
        js, jrender.FrameState(jnp.asarray(STATE[0], jnp.float32),
                               jnp.asarray(STATE[1], jnp.float32)))
    img, aux = tiles.build_sharded_render_fn(pm, 64, 64, -1, ["cpu"] * 4, msaa=msaa,
                                             with_aux=True)(ps, _state())
    assert_frame_parity(img.numpy(), np.asarray(jimg), {k: int(v) for k, v in aux.items()},
                        {k: int(v) for k, v in jaux.items()})


def test_folded_frame_holds_to_the_loop_frame(textured_both):
    """The folded msaa-2 frame (its cones and lists over (32/m)^2-pixel
    patches, its sample mean in another order) against the single-device
    per-sample loop, under the parity rule."""
    _, (ps, pm) = textured_both
    img, aux = tiles.build_sharded_render_fn(pm, 64, 64, -1, ["cpu"] * 2, msaa=2,
                                             with_aux=True)(ps, _state())
    want, waux = pt.build_render_fn(pm, 64, 64, -1, 2, with_aux=True, device="cpu")(ps, _state())
    assert_frame_parity(img.numpy(), want.numpy(), {k: int(v) for k, v in aux.items()},
                        {k: int(v) for k, v in waux.items()})


def test_per_block_mesh_work_matches_jax(textured_both):
    """Mesh-hit rays per block: equal to the JAX package's except on rays
    whose hit differs between the packages (the JAX CPU path contracts
    products into FMAs, the port rounds each; ROADMAP "No FMA contraction"):
    at most 0.1% of a block's 1024 lanes, so one lane. partition_work is
    equal on equal input."""
    from relativitypathtracer_tpu import render as jrender
    from relativitypathtracer_tpu.parallel import tiles as jtiles

    (js, jm), (ps, pm) = textured_both
    jstate = jrender.FrameState(jnp.asarray(STATE[0], jnp.float32),
                                jnp.asarray(STATE[1], jnp.float32))
    want, jr, jc = jtiles.per_block_mesh_work(js, jm, 96, 100, 4, state=jstate)
    got, r, c = tiles.per_block_mesh_work(ps, pm, 96, 100, 4, state=_state())
    assert (r, c) == (jr, jc) and got.shape == want.shape and got.dtype == np.float32
    assert got.sum() > 0 and np.abs(got - want).max() <= 1.0
    for assign in ("strided", "contiguous"):
        counts, skew = tiles.partition_work(want, r, c, 4, assign)
        jcounts, jskew = jtiles.partition_work(want, r, c, 4, assign)
        assert np.array_equal(counts, jcounts) and skew == jskew
    counts, skew = tiles.band_mesh_work(ps, pm, 96, 100, 4, "strided", state=_state())
    assert np.array_equal(counts, tiles.partition_work(got, r, c, 4, "strided")[0])


def test_dryrun_multichip_on_the_cpu():
    out = tiles.dryrun_multichip(4, device="cpu")
    assert out["ok"] and out["hits"] > 0


def test_default_devices_are_cards():
    """The default devices are CUDA devices; a host without one raises
    instead of handing back the CPU."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tiles.default_devices())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tiles.default_devices()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tiles.dryrun_multichip(2)
