"""The port's K1 (shadow-setup chain) against the JAX package's Pallas kernel
in interpret mode, on the lanes a shadow ray is traced for (hit, not the
light itself, N.L > 0), rtol 1e-5. The port indexes the hit object's column
of the matrix table directly where the TPU sums one-hot products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_fixtures import t

from relativitypathtracer_tpu.ops import relmath as jrel
from relativitypathtracer_tpu.ops.pallas import shadow_chain as jsc
from relativitypathtracer_tpu_torch.ops.kernels import shadow_chain as psc


@pytest.mark.parametrize("interval", [-1, 0])
def test_shadow_chain_matches_interpret_kernel(interval):
    rng = np.random.default_rng(200 + interval)
    O, n, light = 4, 4096, 3
    vel = (rng.normal(size=(O, 3)) * 0.25).astype(np.float32)
    vel[light] = 0.0
    cam_v = np.array([0.2, 0.0, -0.1], np.float32)
    L = np.asarray(jrel.matmul4(jrel.lorentz(vel), jrel.lorentz(-cam_v)[None]))
    inv_L = np.asarray(jrel.matmul4(jrel.lorentz(cam_v)[None], jrel.lorentz(-vel)))
    stat = np.asarray(jrel.transform4(L, np.array([[0.5, 0.1, 0.0, 0.2]], np.float32)))
    light_pos = np.array([0.5, 2.0, 4.0], np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32) * 0.4
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    dir4 = np.concatenate([np.full((1, n), float(interval), np.float32), d])
    tt = rng.uniform(2.0, 8.0, n).astype(np.float32)
    tt[rng.uniform(size=n) < 0.2] = 1e20  # misses
    nrm = rng.normal(size=(3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    obj = rng.integers(0, O, n).astype(np.int32)

    mats = np.asarray(jsc.pack_chain_mats(jnp.asarray(L), jnp.asarray(inv_L), jnp.asarray(stat)))
    row = np.asarray(jsc.pack_light_row(jnp.asarray(L[light]), jnp.asarray(inv_L[light]),
                                        jnp.asarray(light_pos)))
    pmats = psc.pack_chain_mats(t(L), t(inv_L), t(stat))
    prow = psc.pack_light_row(t(L[light]), t(inv_L[light]), t(light_pos))
    assert np.array_equal(pmats.numpy(), mats) and np.array_equal(prow.numpy(), row)

    want = [np.asarray(x) for x in jsc.shadow_chain(mats, row, dir4, tt, nrm, obj, interval,
                                                    interpret=True)]
    got = [x.numpy() for x in psc.shadow_chain(t(mats), t(row), t(dir4), t(tt), t(nrm),
                                               t(obj), interval)]
    relevant = (tt < 1e20) & (obj != light) & (want[2] > 0)
    assert relevant.sum() > n // 4
    for g, w, name in zip(got, want, ("hit_pos", "ld3", "ndotl", "tmax", "llen")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[..., relevant], w[..., relevant], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.array_equal(got[2][relevant] > 0, want[2][relevant] > 0)
