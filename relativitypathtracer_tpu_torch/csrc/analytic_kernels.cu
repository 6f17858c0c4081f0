// K3 and K7: sphere and cube hits, for rays that share the camera origin
// (nearest hit) and for shadow rays with their own origins (occlusion).
//
// K3 replaces relativitypathtracer_tpu/ops/pallas/analytic_kernels.py:
// _nearest_kernel (wrapper analytic_nearest_shared), plus the spherical-UV
// transcendentals its wrapper runs outside the kernel (_finish_uv), because
// Mosaic has no atan2/asin and CUDA does.
// K7 replaces _min_t_kernel (wrapper analytic_min_t_general): the minimum
// hit parameter over the occluders, for per-lane origins.
//
// What bounds them on this card: K3 reads 16 bytes of direction and writes
// 28 bytes of results per ray; K7 reads 36 bytes (origin, direction, tmax)
// and writes 4. Each does about 60 fp32 operations per object (two square
// roots and four IEEE divisions among them). With one or two objects they are
// memory-bound passes over the rays; with many objects the per-object
// arithmetic takes over.
//
// Design: one thread per ray; each object's fused constants (a 32-float row
// from pack_analytic_params[_general]: the (3, 4) transform, the object-space
// origin or translation, the normal transform and the object id) sit in
// shared memory and every thread reads the same row at the same time. The
// sphere and cube tests are shared __device__ functions. Spheres are walked
// before cubes. The TPU's per-block live-object lists (which it uses from 5
// objects of a kind on) are not built: every thread walks every object. K3's
// results differ from the culled walk only at exact ties of t; K7's only
// where the nearest occluder lies beyond tmax, which the culled walk may
// report as any value >= tmax. Divisions stay real divisions.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // PARAM_COLS
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float sign_of(float x) {  // jnp.sign
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Unit-sphere hit in object space (intersect_sphere, opencl_kernel.cl:335-359).
// ro: ray origin, dh: unit direction. Returns the distance along dh.
__device__ __forceinline__ float sphere_hit(const float* ro, const float* dh, bool* valid) {
  const float bq = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2]);
  const float cq = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0f;
  const float disc = bq * bq - cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float near = bq - sq;
  const float far = bq + sq;
  const bool use_near = near > rpt::kEps;
  *valid = disc >= 0.0f && (use_near || far > rpt::kEps);
  return use_near ? near : far;
}

// Unit-cube [-1, 1]^3 slab hit (intersect_cube, opencl_kernel.cl:312-333).
// nin gets the hit face's object-space normal (one non-zero axis).
__device__ __forceinline__ float cube_hit(const float* ro, const float* dh, bool* valid,
                                          float* nin) {
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
  *valid = nin[0] != 0.0f || nin[1] != 0.0f || nin[2] != 0.0f;
  return nin[0] != 0.0f ? dc[0] : (nin[1] != 0.0f ? dc[1] : dc[2]);
}

// Rows ax = 0..2 of the (3, 4) transform in p applied to w, left to right.
__device__ __forceinline__ void apply34(const float* p, const float* w, float* out) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    out[ax] = p[4 * ax] * w[0] + p[4 * ax + 1] * w[1] + p[4 * ax + 2] * w[2] +
              p[4 * ax + 3] * w[3];
  }
}

__device__ __forceinline__ void stage_params(const float* params, int G, float* s_p) {
  for (int e = threadIdx.x; e < G * kCols; e += blockDim.x) s_p[e] = params[e];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
analytic_nearest_kernel(const float* __restrict__ params, int n_spheres, int n_cubes,
                        const float* __restrict__ dir4, int n, float* __restrict__ t_out,
                        int* __restrict__ obj_out, float* __restrict__ nrm_out,
                        float* __restrict__ uv_out) {
  extern __shared__ float s_p[];
  const int G = n_spheres + n_cubes;
  stage_params(params, G, s_p);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float w[4] = {dir4[lane], dir4[n + lane], dir4[2 * n + lane], dir4[3 * n + lane]};

  float best_t = rpt::kInf, best_obj = 0.0f, best_kind = 0.0f;
  float bn[3] = {0.0f, 0.0f, 0.0f}, bs[3] = {0.0f, 0.0f, 0.0f};
  for (int g = 0; g < G; ++g) {
    const float* p = s_p + g * kCols;
    const bool is_sphere = g < n_spheres;
    float d[3];
    apply34(p, w, d);
    const float scale = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dh[3] = {d[0] / scale, d[1] / scale, d[2] / scale};
    const float ro[3] = {p[12], p[13], p[14]};
    float dist, s3[3], nin[3];
    bool valid;
    if (is_sphere) {
      dist = sphere_hit(ro, dh, &valid);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s3[k] = ro[k] + dh[k] * dist;
        nin[k] = s3[k];
      }
    } else {
      dist = cube_hit(ro, dh, &valid, nin);
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

__global__ void __launch_bounds__(kThreads)
analytic_min_t_kernel(const float* __restrict__ params, int n_spheres, int n_cubes,
                      const float* __restrict__ o4, const float* __restrict__ dir4,
                      const float* __restrict__ tmax, int n, float* __restrict__ t_out) {
  extern __shared__ float s_p[];
  const int G = n_spheres + n_cubes;
  stage_params(params, G, s_p);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (tmax[lane] == 0.0f) {  // masked lane: its result is not read
    t_out[lane] = rpt::kInf;
    return;
  }
  const float w[4] = {dir4[lane], dir4[n + lane], dir4[2 * n + lane], dir4[3 * n + lane]};
  const float o[4] = {o4[lane], o4[n + lane], o4[2 * n + lane], o4[3 * n + lane]};
  float best = rpt::kInf;
  for (int g = 0; g < G; ++g) {
    const float* p = s_p + g * kCols;
    float d[3], ro[3];
    apply34(p, w, d);
    apply34(p, o, ro);
#pragma unroll
    for (int k = 0; k < 3; ++k) ro[k] = ro[k] + p[12 + k];
    const float scale = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dh[3] = {d[0] / scale, d[1] / scale, d[2] / scale};
    bool valid;
    float nin[3];
    const float dist = g < n_spheres ? sphere_hit(ro, dh, &valid) : cube_hit(ro, dh, &valid, nin);
    const float t = valid ? dist / scale : rpt::kInf;
    best = (t < best || isnan(t)) ? t : best;  // jnp.minimum: NaN propagates
  }
  t_out[lane] = best;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int rpt_analytic_nearest(const void* params, int n_spheres, int n_cubes,
                                    const void* dir4, int n, void* t, void* obj, void* nrm,
                                    void* uv, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres + n_cubes) * kCols * sizeof(float);
  if (const int e = set_smem(reinterpret_cast<const void*>(analytic_nearest_kernel), smem)) {
    return e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  analytic_nearest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), n_spheres, n_cubes,
      static_cast<const float*>(dir4), n, static_cast<float*>(t), static_cast<int*>(obj),
      static_cast<float*>(nrm), static_cast<float*>(uv));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_analytic_min_t(const void* params, int n_spheres, int n_cubes,
                                  const void* o4, const void* dir4, const void* tmax, int n,
                                  void* t, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n_spheres + n_cubes) * kCols * sizeof(float);
  if (const int e = set_smem(reinterpret_cast<const void*>(analytic_min_t_kernel), smem)) {
    return e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  analytic_min_t_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), n_spheres, n_cubes, static_cast<const float*>(o4),
      static_cast<const float*>(dir4), static_cast<const float*>(tmax), n,
      static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}
