// K3: nearest sphere/cube hit for rays that share the camera origin.
//
// Replaces relativitypathtracer_tpu/ops/pallas/analytic_kernels.py:
// _nearest_kernel (wrapper analytic_nearest_shared), plus the spherical-UV
// transcendentals its wrapper runs outside the kernel (_finish_uv), because
// Mosaic has no atan2/asin and CUDA does.
//
// What bounds it on this card: per ray it reads 16 bytes of direction and
// writes 28 bytes of results, and does about 60 fp32 operations per object
// (two square roots and four IEEE divisions among them). With the slice's
// one object it is a memory-bound pass over the rays; with many objects the
// per-object arithmetic takes over.
//
// Design: one thread per ray; each object's fused constants (a 32-float row
// from pack_analytic_params: the (3, 4) dir transform, the object-space
// origin, the normal transform and the object id) sit in shared memory and
// every thread reads the same row at the same time. Spheres are walked
// before cubes and a hit replaces the best only when strictly nearer, as the
// JAX path merges them. The TPU's per-block live-object lists (which it uses
// from 5 objects of a kind on) are not built: every thread walks every
// object. Results differ from the culled walk only at exact ties of t.
// Divisions dh = d / scale and t = dist / scale stay real divisions.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // PARAM_COLS
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float sign_of(float x) {  // jnp.sign
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__global__ void __launch_bounds__(kThreads)
analytic_nearest_kernel(const float* __restrict__ params, int n_spheres, int n_cubes,
                        const float* __restrict__ dir4, int n, float* __restrict__ t_out,
                        int* __restrict__ obj_out, float* __restrict__ nrm_out,
                        float* __restrict__ uv_out) {
  extern __shared__ float s_p[];
  const int G = n_spheres + n_cubes;
  for (int e = threadIdx.x; e < G * kCols; e += blockDim.x) s_p[e] = params[e];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float w0 = dir4[lane], w1 = dir4[n + lane], w2 = dir4[2 * n + lane],
              w3 = dir4[3 * n + lane];

  float best_t = rpt::kInf, best_obj = 0.0f, best_kind = 0.0f;
  float bn[3] = {0.0f, 0.0f, 0.0f}, bs[3] = {0.0f, 0.0f, 0.0f};
  for (int g = 0; g < G; ++g) {
    const float* p = s_p + g * kCols;
    const bool is_sphere = g < n_spheres;
    float d[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      d[ax] = p[4 * ax] * w0 + p[4 * ax + 1] * w1 + p[4 * ax + 2] * w2 + p[4 * ax + 3] * w3;
    }
    const float scale = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dh[3] = {d[0] / scale, d[1] / scale, d[2] / scale};
    const float ro[3] = {p[12], p[13], p[14]};
    float dist, s3[3], nin[3];
    bool valid;
    if (is_sphere) {
      const float bq = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2]);
      const float cq = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0f;
      const float disc = bq * bq - cq;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float near = bq - sq;
      const float far = bq + sq;
      const bool use_near = near > rpt::kEps;
      dist = use_near ? near : far;
      valid = disc >= 0.0f && (use_near || far > rpt::kEps);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s3[k] = ro[k] + dh[k] * dist;
        nin[k] = s3[k];
      }
    } else {
      const bool inside = fmaxf(fmaxf(fabsf(ro[0]), fabsf(ro[1])), fabsf(ro[2])) < 1.0f;
      const float winding = inside ? -1.0f : 1.0f;
      float sgn[3], dc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sgn[k] = -sign_of(dh[k]);
        dc[k] = (winding * sgn[k] - ro[k]) / dh[k];
      }
      bool face[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int a1 = (ax + 1) % 3, a2 = (ax + 2) % 3;
        const float p1 = fabsf(ro[a1] + dh[a1] * dc[ax]);
        const float p2 = fabsf(ro[a2] + dh[a2] * dc[ax]);
        face[ax] = dc[ax] >= 0.0f && p1 < 1.0f && p2 < 1.0f;
      }
      nin[0] = face[0] ? sgn[0] : 0.0f;
      nin[1] = (!face[0] && face[1]) ? sgn[1] : 0.0f;
      nin[2] = (!face[0] && !face[1] && face[2]) ? sgn[2] : 0.0f;
      dist = nin[0] != 0.0f ? dc[0] : (nin[1] != 0.0f ? dc[1] : dc[2]);
      valid = nin[0] != 0.0f || nin[1] != 0.0f || nin[2] != 0.0f;
      float pt[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pt[k] = ro[k] + dh[k] * dist;
      const bool on_x = nin[0] != 0.0f, on_y = nin[1] != 0.0f;
      const float u = on_x ? pt[1] : pt[0];
      const float v = (on_x || on_y) ? pt[2] : pt[1];
      s3[0] = (u + 1.0f) / 2.0f;
      s3[1] = (v + 1.0f) / 2.0f;
      s3[2] = 0.0f;
    }
    // normal: NT @ n, normalized
    float nt[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      nt[ax] = p[15 + 3 * ax] * nin[0] + p[15 + 3 * ax + 1] * nin[1] + p[15 + 3 * ax + 2] * nin[2];
    }
    const float ninv = 1.0f / sqrtf(nt[0] * nt[0] + nt[1] * nt[1] + nt[2] * nt[2]);
    const float t = valid ? dist / scale : rpt::kInf;
    if (t < best_t) {
      best_t = t;
      best_obj = p[24];
      best_kind = is_sphere ? 0.0f : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bn[k] = nt[k] * ninv;
        bs[k] = s3[k];
      }
    }
  }
  t_out[lane] = best_t;
  obj_out[lane] = static_cast<int>(best_obj);
#pragma unroll
  for (int k = 0; k < 3; ++k) nrm_out[static_cast<size_t>(k) * n + lane] = bn[k];
  if (best_kind == 0.0f) {
    uv_out[lane] = 0.5f + atan2f(bs[2], bs[0]) / kTwoPi;
    uv_out[n + lane] = asinf(fminf(fmaxf(bs[1], -1.0f), 1.0f)) / kPi + 0.5f;
  } else {
    uv_out[lane] = bs[0];
    uv_out[n + lane] = bs[1];
  }
}

}  // namespace

extern "C" int rpt_analytic_nearest(const void* params, int n_spheres, int n_cubes,
                                    const void* dir4, int n, void* t, void* obj, void* nrm,
                                    void* uv, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres + n_cubes) * kCols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analytic_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  analytic_nearest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), n_spheres, n_cubes,
      static_cast<const float*>(dir4), n, static_cast<float*>(t), static_cast<int*>(obj),
      static_cast<float*>(nrm), static_cast<float*>(uv));
  return static_cast<int>(cudaGetLastError());
}
