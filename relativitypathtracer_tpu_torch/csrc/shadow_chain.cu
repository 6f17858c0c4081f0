// K1: the shadow-setup chain for one light.
//
// Replaces relativitypathtracer_tpu/ops/pallas/shadow_chain.py:_chain_kernel
// (wrapper shadow_chain). Per ray: select the hit object's L, invL and
// stationaryCam by object id; rebuild the camera-frame hit event with a
// 0.001 normal bias; hop to the light's frame; form the retarded direction
// (interval * |d|, d) to the light; hop back to the camera frame and to the
// hit object's frame; return N.L, the light distance tmax and |ld_of|
// (opencl_kernel.cl:572-599).
//
// What bounds it on this card: memory. Per ray it reads 40 bytes (dir4, t,
// normal, object id) and writes 40 (hit event, light direction, N.L, tmax,
// |ld_of|) around about 150 fp32 operations, far below the card's ratio of
// operations to bytes.
//
// Design: one thread per ray, each reading and writing its lanes once. The
// (40, O) per-object matrix table and the light's 36-float row sit in shared
// memory, and the thread indexes column `obj` directly where the TPU selects
// it with O one-hot multiply-adds (the one-hot sum equals the column).
// Lanes that missed compute with a t = 1 stand-in; every consumer masks them.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 40;   // MROWS: L(16) | invL(16) | stat_cam(4) | pad
constexpr int kLight = 36;  // L_light(16) | invL_light(16) | light_pos(3) | pad

__global__ void __launch_bounds__(kThreads)
shadow_chain_kernel(const float* __restrict__ mats, int O, const float* __restrict__ light,
                    const float* __restrict__ dir4, const float* __restrict__ t_in,
                    const float* __restrict__ nrm_in, const int* __restrict__ obj_in,
                    float interval, int n, float* __restrict__ hit_out,
                    float* __restrict__ ld_out, float* __restrict__ ndotl_out,
                    float* __restrict__ tmax_out, float* __restrict__ llen_out) {
  extern __shared__ float s_m[];  // (kRows, O) then the light row
  float* s_light = s_m + kRows * O;
  for (int e = threadIdx.x; e < kRows * O; e += blockDim.x) s_m[e] = mats[e];
  for (int e = threadIdx.x; e < kLight; e += blockDim.x) s_light[e] = light[e];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float t = t_in[lane];
  const bool hit = t < rpt::kInf;
  const float ts = hit ? t : 1.0f;
  float nr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nr[k] = hit ? nrm_in[static_cast<size_t>(k) * n + lane] : 0.0f;
  const int o = obj_in[lane];
  auto sel = [&](int row) { return s_m[row * O + o]; };
  float d4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d4[i] = dir4[static_cast<size_t>(i) * n + lane];

  // 4x4 applies, each row summed left to right as the TPU kernel does.
  auto apply_sel = [&](int base, const float* v, float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = sel(base + 4 * i) * v[0] + sel(base + 4 * i + 1) * v[1] +
               sel(base + 4 * i + 2) * v[2] + sel(base + 4 * i + 3) * v[3];
    }
  };
  auto apply_light = [&](int base, const float* v, float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = s_light[base + 4 * i] * v[0] + s_light[base + 4 * i + 1] * v[1] +
               s_light[base + 4 * i + 2] * v[2] + s_light[base + 4 * i + 3] * v[3];
    }
  };

  float ray_of[4], hp_of[4], hp[4], hp_lf[4], ld_lf[4], ld[4], ld_of[4];
  apply_sel(0, d4, ray_of);  // ray direction in the hit object's frame
#pragma unroll
  for (int i = 0; i < 4; ++i) hp_of[i] = sel(32 + i) + ray_of[i] * ts;
#pragma unroll
  for (int k = 0; k < 3; ++k) hp_of[1 + k] = hp_of[1 + k] + nr[k] * 0.001f;
  apply_sel(16, hp_of, hp);  // hit event in the camera frame
  apply_light(0, hp, hp_lf);  // ... in the light's frame
#pragma unroll
  for (int k = 0; k < 3; ++k) ld_lf[1 + k] = s_light[32 + k] - hp_lf[1 + k];
  ld_lf[0] = interval * sqrtf(ld_lf[1] * ld_lf[1] + ld_lf[2] * ld_lf[2] + ld_lf[3] * ld_lf[3]);
  apply_light(16, ld_lf, ld);  // retarded light direction, camera frame
  apply_sel(0, ld, ld_of);  // ... hit object's frame

  const float llen = sqrtf(ld_of[1] * ld_of[1] + ld_of[2] * ld_of[2] + ld_of[3] * ld_of[3]);
  const float inv_llen = 1.0f / fmaxf(llen, 1e-20f);
  const float ndotl = (nr[0] * ld_of[1] + nr[1] * ld_of[2] + nr[2] * ld_of[3]) * inv_llen;
  const float tmax = sqrtf(ld[1] * ld[1] + ld[2] * ld[2] + ld[3] * ld[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) hit_out[static_cast<size_t>(i) * n + lane] = hp[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) ld_out[static_cast<size_t>(k) * n + lane] = ld[1 + k];
  ndotl_out[lane] = ndotl;
  tmax_out[lane] = tmax;
  llen_out[lane] = llen;
}

}  // namespace

extern "C" int rpt_shadow_chain(const void* mats, int O, const void* light, const void* dir4,
                                const void* t, const void* nrm, const void* obj,
                                float interval, int n, void* hit, void* ld, void* ndotl,
                                void* tmax, void* llen, void* stream) {
  const size_t smem = (static_cast<size_t>(kRows) * O + kLight) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shadow_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  shadow_chain_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), O, static_cast<const float*>(light),
      static_cast<const float*>(dir4), static_cast<const float*>(t),
      static_cast<const float*>(nrm), static_cast<const int*>(obj), interval, n,
      static_cast<float*>(hit), static_cast<float*>(ld), static_cast<float*>(ndotl),
      static_cast<float*>(tmax), static_cast<float*>(llen));
  return static_cast<int>(cudaGetLastError());
}
