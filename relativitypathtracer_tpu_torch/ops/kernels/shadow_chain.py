"""Shadow-setup chain: K1, hit reconstruction and the frame-hopping light
direction for one light.

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.shadow_chain`
(opencl_kernel.cl:572-599): the hit object's L, invL and stationaryCam are
selected by object id; the camera-frame hit event is rebuilt with a 0.001
normal bias; it hops to the light's frame, where the retarded direction
(interval * |d|, d) to the light is formed; that hops back to the camera
frame and to the hit object's frame for N.L. Lanes that missed compute with
t = 1 stand-ins; every consumer masks them.

`shadow_chain` calls the operator torch.ops.rpt.shadow_chain, which launches
the CUDA kernel (csrc/shadow_chain.cu) on CUDA tensors and runs its plain twin
`shadow_chain_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from ._build import check_cuda, define_op, launch, on_cpu

INF = 1e20
MROWS = 40  # per-object table rows: L(16) | invL(16) | stat_cam(4) | pad
LIGHT_COLS = 36  # light row: L(16) | invL(16) | light position(3) | pad


def pack_chain_mats(L, inv_L, stat_cam):
    """(MROWS, O) per-object table: L and invL row-major, then stat_cam."""
    O = L.shape[0]
    return torch.cat([L.reshape(O, 16), inv_L.reshape(O, 16), stat_cam,
                      torch.zeros((O, MROWS - 36), device=L.device)], dim=1).T.contiguous()


def pack_light_row(L_i, inv_L_i, light_pos3):
    """(1, LIGHT_COLS) row of the light: its L, invL and position."""
    return torch.cat([L_i.reshape(16), inv_L_i.reshape(16), light_pos3,
                      torch.zeros(1, device=L_i.device)])[None, :].contiguous()


def _apply4(m, base: int, v):
    """[sum_j m[base + 4i + j] * v[j] for i in 0..3], left to right."""
    return [m[base + 4 * i] * v[0] + m[base + 4 * i + 1] * v[1]
            + m[base + 4 * i + 2] * v[2] + m[base + 4 * i + 3] * v[3] for i in range(4)]


def shadow_chain_plain(mats, light_row, dir4, t, normal, obj, interval: int):
    """Plain twin of the K1 kernel. Returns (hit_pos4 (4, N) camera frame,
    ld3 (3, N) camera frame, ndotl, tmax, llen (N,))."""
    hit = t < INF
    ts = torch.where(hit, t, 1.0)
    nrm = [torch.where(hit, normal[k], 0.0) for k in range(3)]
    sel = mats[:, obj.long()]  # (MROWS, N): the hit object's column
    light = light_row[0]
    ray_of = _apply4(sel, 0, [dir4[i] for i in range(4)])
    hp_of = [sel[32 + i] + ray_of[i] * ts for i in range(4)]
    for k in range(3):
        hp_of[1 + k] = hp_of[1 + k] + nrm[k] * 0.001
    hp = _apply4(sel, 16, hp_of)
    hp_lf = _apply4(light, 0, hp)
    ld3_lf = [light[32 + k] - hp_lf[1 + k] for k in range(3)]
    nlf = torch.sqrt(ld3_lf[0] * ld3_lf[0] + ld3_lf[1] * ld3_lf[1] + ld3_lf[2] * ld3_lf[2])
    ld = _apply4(light, 16, [float(interval) * nlf] + ld3_lf)
    ld_of = _apply4(sel, 0, ld)
    llen = torch.sqrt(ld_of[1] * ld_of[1] + ld_of[2] * ld_of[2] + ld_of[3] * ld_of[3])
    ndotl = (nrm[0] * ld_of[1] + nrm[1] * ld_of[2] + nrm[2] * ld_of[3]) * (
        1.0 / torch.clamp(llen, min=1e-20))
    tmax = torch.sqrt(ld[1] * ld[1] + ld[2] * ld[2] + ld[3] * ld[3])
    return torch.stack(hp), torch.stack(ld[1:4]), ndotl, tmax, llen


def _shadow_chain_cuda(mats, light_row, dir4, t, normal, obj, interval: int):
    n = dir4.shape[1]
    f32 = torch.float32
    check_cuda("shadow_chain", (mats, f32, (MROWS, mats.shape[1])),
               (light_row, f32, (1, LIGHT_COLS)), (dir4, f32, (4, n)), (t, f32, (n,)),
               (normal, f32, (3, n)), (obj, torch.int32, (n,)))
    hit, ld, ndotl, tmax, llen = _shadow_chain_fake(mats, light_row, dir4, t, normal, obj,
                                                    interval)
    launch("rpt_shadow_chain", mats, mats.shape[1], light_row, dir4, t, normal, obj,
           float(interval), n, hit, ld, ndotl, tmax, llen)
    return hit, ld, ndotl, tmax, llen


def _shadow_chain_fake(mats, light_row, dir4, t, normal, obj, interval: int):
    n = dir4.shape[1]
    return (dir4.new_empty((4, n)), dir4.new_empty((3, n)),
            *(dir4.new_empty(n) for _ in range(3)))


_shadow_chain_op = define_op(
    "shadow_chain", "(Tensor mats, Tensor light_row, Tensor dir4, Tensor t, Tensor normal, "
    "Tensor obj, int interval) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _shadow_chain_cuda, shadow_chain_plain, _shadow_chain_fake)


def shadow_chain(mats, light_row, dir4, t, normal, obj, interval: int):
    """K1 for one light: the CUDA kernel on CUDA tensors, the plain twin on
    CPU tensors. mats: (MROWS, O); light_row: (1, LIGHT_COLS); dir4: (4, N);
    t: (N,); normal: (3, N) rest frame; obj: (N,) int32."""
    if not on_cpu("shadow_chain", dir4):
        dir4, t, normal = dir4.contiguous(), t.contiguous(), normal.contiguous()
    return _shadow_chain_op(mats, light_row, dir4, t, normal, obj, int(interval))
