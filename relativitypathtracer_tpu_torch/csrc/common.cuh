// Shared constants and helpers of the port's hand-written Hopper kernels.
//
// Every source here is compiled with -fmad=false: a multiply followed by an
// add is rounded twice, as in the JAX package's kernels and in the plain
// PyTorch twins, so the acceptance tests of the ray/triangle and ray/box
// math (|det| >= 1e-7, the [0, 1] barycentric tests) decide the same way.
// Division and square root are IEEE (no --use_fast_math).
#pragma once

#include <cuda_runtime.h>

namespace rpt {

constexpr float kInf = 1e20f;   // the JAX package's INF stand-in
constexpr float kEps = 1e-7f;   // Moller-Trumbore det epsilon
constexpr int kNB = 1024;       // rays per block: one 32x32 screen tile
constexpr int kTC = 32;         // triangles per chunk

// NaN-safe reciprocal for slab tests (mesh_kernels._safe_inv): |d| is
// clamped to 1e-12 so an axis-parallel ray on a box plane gives a huge
// finite t instead of 0 * inf = NaN.
__device__ __forceinline__ float safe_inv(float d) {
  const float dd = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / dd;
}

// Per-lane walk bound from the union box of the chunk spheres: the exit
// distance with the kernels' margin (far * 1.001 + 1e-3), or 0 for a ray
// that misses the box.
__device__ __forceinline__ float box_bound(const float* lo, const float* hi,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
  const float o[3] = {ox, oy, oz};
  const float d[3] = {dx, dy, dz};
  float far = kInf, near = -kInf;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float inv = safe_inv(d[ax]);
    const float t0 = (lo[ax] - o[ax]) * inv;
    const float t1 = (hi[ax] - o[ax]) * inv;
    near = fmaxf(near, fminf(t0, t1));
    far = fminf(far, fmaxf(t0, t1));
  }
  return (near <= far && far > 0.0f) ? far * 1.001f + 1e-3f : 0.0f;
}

// Moller-Trumbore acceptance in the TPU's form: one reciprocal 1/det, then
// products (mesh_kernels._mt_mask).
__device__ __forceinline__ bool mt_accept(float det, float un, float vn, float tn,
                                          float* u, float* v, float* dist) {
  const float inv = 1.0f / det;
  *u = un * inv;
  *v = vn * inv;
  *dist = tn * inv;
  return fabsf(det) >= kEps && *u >= 0.0f && *u <= 1.0f && *v >= 0.0f &&
         *u + *v <= 1.0f && *dist >= 0.0f;
}

// The three sums of a ray from the shared origin against the row c
// [det(3) u(3) v(3) ct] of mesh_kernels.shared_tri_rows, d the unit
// object-space direction. Sums run left to right, as the twins'.
__device__ __forceinline__ void shared_tri_sums(const float* c, float dx, float dy, float dz,
                                                float* det, float* un, float* vn) {
  *det = c[0] * dx + c[1] * dy + c[2] * dz;
  *un = c[3] * dx + c[4] * dy + c[5] * dz;
  *vn = c[6] * dx + c[7] * dy + c[8] * dz;
}

// One triangle against a ray from the shared origin: its sums, then the
// acceptance.
__device__ __forceinline__ bool shared_tri_test(const float* c, float dx, float dy, float dz,
                                                float* u, float* v, float* dist) {
  float det, un, vn;
  shared_tri_sums(c, dx, dy, dz, &det, &un, &vn);
  return mt_accept(det, un, vn, c[9], u, v, dist);
}

// The four sums of a general ray x = [d, o x d, o, 1] against the row c
// [det(3) u(6) v(6) t(4) pad] of mesh_kernels.general_tri_rows.
__device__ __forceinline__ void general_tri_sums(const float* c, const float* x, float* det,
                                                 float* un, float* vn, float* tn) {
  *det = c[0] * x[0] + c[1] * x[1] + c[2] * x[2];
  *un = c[3] * x[0] + c[4] * x[1] + c[5] * x[2] + c[6] * x[3] + c[7] * x[4] + c[8] * x[5];
  *vn = c[9] * x[0] + c[10] * x[1] + c[11] * x[2] + c[12] * x[3] + c[13] * x[4] + c[14] * x[5];
  *tn = c[15] * x[6] + c[16] * x[7] + c[17] * x[8] + c[18] * x[9];
}

// One triangle against a general ray: its sums, then the acceptance.
__device__ __forceinline__ bool general_tri_test(const float* c, const float* x, float* dist) {
  float det, un, vn, tn, u, v;
  general_tri_sums(c, x, &det, &un, &vn, &tn);
  return mt_accept(det, un, vn, tn, &u, &v, dist);
}

// Max of `v` over the block; every thread gets the same value, so a loop
// that tests it is uniform across the block. s_red holds one float per warp.
template <int THREADS>
__device__ __forceinline__ float block_max(float v, float* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // earlier readers of s_red are done
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, s_red[w]);
  return m;
}

}  // namespace rpt

extern "C" const char* rpt_error_string(int code);
