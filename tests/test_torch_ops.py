"""The port's elementwise ops against the JAX package's, on seeded inputs.

Tolerance 1e-6 absolute and relative (fp32 products summed in another order
by another library), exact for the tile swizzle.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import t

from relativitypathtracer_tpu import render as jrender
from relativitypathtracer_tpu.ops import camera as jcamera
from relativitypathtracer_tpu.ops import intersect as jintersect
from relativitypathtracer_tpu.ops import relmath as jrel
from relativitypathtracer_tpu.ops import tonemap as jtone
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.ops import camera as pcamera
from relativitypathtracer_tpu_torch.ops import intersect as pintersect
from relativitypathtracer_tpu_torch.ops import relmath as prel
from relativitypathtracer_tpu_torch.ops import tonemap as ptone

TOL = dict(rtol=1e-6, atol=1e-6)


def _velocities(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v *= (rng.uniform(0.0, 0.9, (n, 1)) / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    v[0] = 0.0  # the exact-identity case
    return v


def test_lorentz_matches_jax():
    v = _velocities(np.random.default_rng(1), 16)
    np.testing.assert_allclose(prel.lorentz(t(v)).numpy(), np.asarray(jrel.lorentz(v)), **TOL)
    assert torch.equal(prel.lorentz(t(v[:1]))[0], torch.eye(4))


def test_matmul4_and_transform4_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(8, 4, 4)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(8, 4)).astype(np.float32)
    np.testing.assert_allclose(prel.matmul4(t(a), t(b)).numpy(),
                               np.asarray(jrel.matmul4(a, b)), **TOL)
    np.testing.assert_allclose(prel.transform4(t(a), t(v)).numpy(),
                               np.asarray(jrel.transform4(a, v)), **TOL)


@pytest.mark.parametrize("angle", [0.0, 0.4, 2.5, -1.2])
def test_trs_and_inverse4_match_jax(angle):
    rng = np.random.default_rng(3)
    tr = rng.normal(size=3).astype(np.float32)
    axis = rng.normal(size=3).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, 3).astype(np.float32)
    want = np.asarray(jrel.trs(tr, np.float32(angle), axis, scale))
    got = prel.trs(tr, np.float32(angle), axis, scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(prel.inverse4(got).numpy(), np.asarray(jrel.inverse4(want)),
                               rtol=1e-5, atol=1e-6)


def test_object_frames_match_jax():
    rng = np.random.default_rng(4)
    vel = _velocities(rng, 5)
    cam_v = np.array([0.3, -0.2, 0.1], np.float32)
    cam_p = np.array([1.5, 0.2, -0.3, 0.4], np.float32)
    jo, po = SimpleNamespace(velocity=jnp.asarray(vel)), SimpleNamespace(velocity=t(vel))
    want = jrender.object_frames(jo, jrender.FrameState(jnp.asarray(cam_v), jnp.asarray(cam_p)))
    got = prender.object_frames(po, prender.FrameState(t(cam_v), t(cam_p)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("size", [(64, 48, 64, 64), (100, 30, 128, 32)])
def test_camera_ray_dirs_match_jax(size):
    w, h, pw, ph = size
    want = np.asarray(jcamera.camera_ray_dirs(w, h, 1, pad_width=pw, pad_height=ph))
    got = pcamera.camera_ray_dirs(w, h, 1, pw, ph, device="cpu").numpy()
    assert got.shape == want.shape == (ph, pw, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("msaa", [2, 3])
def test_camera_ray_dirs_msaa_match_jax(msaa):
    """msaa**2 sample sets at offsets k/msaa, x fastest: (msaa**2, H, W, 3)."""
    want = np.asarray(jcamera.camera_ray_dirs(40, 24, msaa, pad_width=64, pad_height=32))
    got = pcamera.camera_ray_dirs(40, 24, msaa, 64, 32, device="cpu").numpy()
    assert got.shape == want.shape == (msaa * msaa, 32, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)


def _rays(rng, n):
    inv_m = np.asarray(jrel.inverse4(jrel.trs(
        np.array([0.2, -0.1, 4.0], np.float32), np.float32(0.6),
        np.array([0.3, 1.0, 0.2], np.float32), np.array([1.0, 1.5, 0.8], np.float32))))
    o = np.array([0.05, 0.02, 0.0], np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32) * 0.3
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    return inv_m, o, d


@pytest.mark.parametrize("kind", ["sphere", "cube"])
def test_analytic_intersectors_match_jax(kind):
    inv_m, o, d = _rays(np.random.default_rng(5), 4096)
    jfn = getattr(jintersect, f"{kind}_intersect")
    pfn = getattr(pintersect, f"{kind}_intersect")
    jt, jn, juv, jv = (np.asarray(x) for x in jfn(inv_m, o, d))
    pt_, pn, puv, pv = (x.numpy() for x in pfn(t(inv_m), t(o), t(d)))
    assert np.array_equal(pv, jv) and jv.any() and not jv.all()
    np.testing.assert_allclose(pt_[jv], jt[jv], **TOL)
    np.testing.assert_allclose(pn[:, jv], jn[:, jv], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(puv[:, jv], juv[:, jv], rtol=1e-5, atol=1e-5)


def test_tonemap_matches_jax():
    rng = np.random.default_rng(6)
    c = rng.uniform(0.0, 4.0, (512, 3)).astype(np.float32)
    wp = np.array([1.0, 1.5, 2.0], np.float32)
    np.testing.assert_allclose(ptone.tonemap(t(c), t(wp)).numpy(),
                               np.asarray(jtone.tonemap(c, wp)), **TOL)


@pytest.mark.parametrize("ph,pw", [(32, 32), (64, 96), (768, 1024)])
def test_tile_swizzle_matches_jax_exactly(ph, pw):
    x = np.arange(3 * ph * pw, dtype=np.float32).reshape(3, ph * pw)
    want = np.asarray(jrender.tile_swizzle(x, ph, pw))
    got = prender.tile_swizzle(t(x), ph, pw)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(prender.tile_unswizzle(got, ph, pw).numpy(), x)
    assert np.array_equal(np.asarray(jrender.tile_unswizzle(want, ph, pw)), x)


def test_texture_layout_is_bit_exact_on_tensors():
    """The port's texture addressing on torch tensors equals the JAX
    package's on numpy arrays."""
    from relativitypathtracer_tpu.ops import texture_layout as jtl
    from relativitypathtracer_tpu_torch.ops import texture_layout as ptl

    rng = np.random.default_rng(7)
    wb = rng.integers(1, 257, 2000)
    rh = rng.integers(1, 4097, 2000)
    lx = rng.integers(0, 16 * wb)
    ly = rng.integers(0, rh)
    want = jtl.tile_slot(lx, ly, wb, rh)
    got = ptl.tile_slot(t(lx), t(ly), t(wb), t(rh))
    assert np.array_equal(got.numpy(), want)
    for a, b in zip(ptl.tile_params(t(wb), t(rh)), jtl.tile_params(wb, rh)):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(ptl.region_quads(t(wb), t(rh)).numpy(), jtl.region_quads(wb, rh))
