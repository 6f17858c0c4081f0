// K3 and K7: sphere and cube hits, for rays that share the camera origin
// (nearest hit) and for shadow rays with their own origins (occlusion).
//
// K3 replaces relativitypathtracer_tpu/ops/pallas/analytic_kernels.py:
// _nearest_kernel (:308, wrapper analytic_nearest_shared), plus the
// spherical-UV transcendentals its wrapper runs outside the kernel
// (_finish_uv, :437), because Mosaic has no atan2/asin and CUDA does.
// K7 replaces _min_t_kernel (:521, wrapper analytic_min_t_general): the
// minimum hit parameter over the occluders, for per-lane origins.
//
// What bounds them on this card: K3 reads 16 bytes of direction and writes
// 28 bytes of results per ray; K7 reads 36 bytes (origin, direction, tmax)
// for a lane with tmax > 0, 4 (tmax) for a masked one, and writes 4. A full
// object test is 150-200 instructions (IEEE divisions for dh, t and the
// slabs, two square roots, the normal transform): with 10 objects that is
// well above the bytes. But most (warp, object) pairs hit nothing: on the
// cubes path 5% of K3's and 0.1% of K7's have any lane that the full test
// finds valid (PERF.md). With the vote below, what remains is the
// pre-test's issue slots over every lane and object (about 55 a K3 object
// and 95 a K7 object per warp, by the SASS), the 5-6% of full tests the
// votes run, and the bytes: on an NVIDIA H100 80GB HBM3 at 700 W, K3 on
// the cubes path (10 objects) takes about 0.025 ms against 0.0103 ms of
// bytes.
//
// Design: one thread per ray. Each object's fused constants (a 32-float row
// from pack_analytic_params[_general]: the (3, 4) transform A, the
// object-space origin or translation, the normal transform and the object
// id) are staged in shared memory, 16-byte aligned so that a row's
// transform is three 16-byte loads, and for K3 the pre-test's per-object
// constants derived from the staged row. For each object in index order,
// spheres before cubes, every lane runs a cheap pre-test (may_hit, below;
// plain form analytic_kernels.object_may_hit_plain): whether the line from
// ro along d = A w (s >= 0) may meet the object's bounding sphere |x|^2 <=
// r^2, r^2 = 1 for the unit sphere, 3 for the cube [-1, 1]^3. Then the warp
// votes (__any_sync): if no lane may hit, the warp skips the object; else
// every lane runs the full test, the twin's fp32 operations in the twin's
// order, unchanged. The pre-test's comparisons combine with bitwise & and |,
// without branches (6% faster than short-circuit code on cubes). Lanes past
// n and K7's masked lanes (tmax == 0) stay to the end so that every vote
// has its 32 lanes; they vote no and store nothing (K7's masked lanes store
// INF), and a K7 warp without an active lane skips the walk. K3 writes a
// no-hit lane's uv as the (0.5, 0.5) that the twin's atan2(0, 0) and asin(0)
// give, without the two transcendentals. A non-null `tested` counts the
// (warp, object) pairs that ran the full test (one atomic a pair); the
// frame path passes null. Measured and not kept (PERF.md): the votes of 32
// objects first and then the full tests of the voted ones (K3 no faster,
// K7 8% slower), and 4 chunks of 256 lanes a CTA with the next chunk's
// inputs loaded ahead (one wave of CTAs: 13-60% slower).
//
// Why the output stays bit for bit with the twins. The pre-test is sound
// lane by lane: "may_hit false" implies that the full test's `valid` is
// false for that lane and object (the margins below). A skipped object's
// test would give t = INF on every lane of the warp, and with the strict
// t < best_t (K3) and t < best || isnan(t) (K7) an INF changes nothing.
// Wherever a test runs, it is the same operations on the same inputs (d and
// ro are formed as the full test forms them), and the walk stays in index
// order with strict <, so ties keep the twin's winner.
//
// The pre-test's margins (analytic_kernels.PRETEST_KAPPA, _MU, _DD_MIN). With
// rr = |ro|^2, c = rr - r^2, rd = ro . d, dd = |d|^2 (sums left to right),
// disc = rd^2 - dd c, a lane is dead where disc is finite, dd >= D and
//   disc < -dd K (rr + r^2)   (the line misses the ball), or
//   rd > 0 and c > M rr       (it starts outside and moves away),
// with u = 2^-24, K = M = 2^-14 = 1024u, D = 2^-100. d and ro are the full
// test's own floats, so only the rounding after them matters; with û = d /
// |d| exact:
//  1. Sphere. The twin's dh is within 3.5u of û per component, its bq =
//     -ro . dh within 6.5u |ro| of -ro . û, and its disc = bq^2 - (rr - 1)
//     within 20u (rr + 1) of the exact (ro . û)^2 - (rr - 1) = disc' / dd.
//     The pre-test's disc is within 20u dd (rr + r^2) of the exact disc'. So
//     a twin disc >= 0 gives a pre-test disc >= -40u dd (rr + 1), above -dd
//     K (rr + 1). Moving away: rd > 0 gives ro . û >= -3u |ro|, so bq <=
//     9.5u |ro|, and c > M rr makes the twin's rr - 1 at least (M - 8u) rr,
//     so its disc is negative (and with bq <= 0 its far root could not
//     exceed eps = 1e-7 > 0 anyway: near and far need > eps, which only
//     narrows the twin's hits).
//  2. Cube. A valid face gives a point X = ro + dc dh, dc >= 0, whose float
//     slab coordinates are < 1 and whose face coordinate is +-1: X lies in
//     the cube grown by 3u (|ro| + |dc| + 1), and dc <= 1.01 (|ro| + 2). The
//     point at the same parameter on the exact line, ahead of ro, is within
//     3.5u dc of X, so within sqrt(3) + u (12.2 |ro| + 19) of the centre:
//     the exact disc' / dd >= -u (21.5 rr + 88) >= -30u (rr + 3), and with
//     the pre-test's rounding its disc >= -50u dd (rr + 3), above the -dd K
//     (rr + 3) it gives away. The corners lie exactly on the sqrt(3) sphere,
//     so at a corner only these margins separate a float p1 < 1 from a
//     rejected lane. Moving away: every point ahead of ro on the exact line
//     has |x|^2 >= rr - 9u^2 rr > 3 + (M - 5u) rr, above the grown ball's (3
//     + 47u rr) when M > 52u.
//  So K and M hold the bounds with 20x room. They hold for any transform
//  A: the floor's 7 x 0.1 x 6 scale and boosts up to 0.9c only change d and
//  ro, which the full test shares. Below dd = D the squares of d may be
//  subnormal and the relative bounds fail: such a lane may hit. Every
//  "dead" comparison needs a finite disc (which rr, rd and dd all reach), so
//  a NaN or infinite origin, direction or row reads as "may hit". The CPU
//  tests (tests/test_torch_analytic_kernels.py) hold the implication on
//  10^5 adversarial (lane, object) pairs a case: tangents within ulps, cube
//  edges and corners, origins inside and on the ball, the floor's scale,
//  0.6c and 0.9c, interval 0, zero, huge and NaN directions.
//
// What the per-lane vote replaces. The TPU kernels walk per-block lists of
// the objects whose bounding spheres a block's rays may reach (live_objects,
// :121, :176), in front-to-back order with floor termination. Here a
// warp's vote is the finer grain (32 rays, not 1,024), costs one pre-test
// (30-70 operations) a lane and object against the full test's 150-200, and
// needs no list build and no launch. Front-to-back order would move exact
// ties off the twin's index order, and with at most a few dozen objects the
// floor termination has little to end early.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // PARAM_COLS
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;
constexpr unsigned kFull = 0xffffffffu;
// the pre-test's margins (see above; analytic_kernels.PRETEST_KAPPA, _MU, _DD_MIN)
constexpr float kKappa = 1.0f / 16384.0f;
constexpr float kMu = 1.0f / 16384.0f;
constexpr float kDdMin = 7.888609052210118e-31f;  // 2^-100
constexpr int kConsts = 4;  // K3's per-object pre-test constants: rr, c, K (rr + r^2), M rr

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

// Rows ax = 0..2 of the (3, 4) transform in the row p applied to w, left to
// right. The row is read as three 16-byte loads (p is a shared-memory row,
// 16-byte aligned).
__device__ __forceinline__ void apply34(const float* p, const float* w, float* out) {
  const float4* a = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float4 r = a[ax];
    out[ax] = r.x * w[0] + r.y * w[1] + r.z * w[2] + r.w * w[3];
  }
}

__device__ __forceinline__ float bound_r2(bool is_sphere) { return is_sphere ? 1.0f : 3.0f; }

// The pre-test's constants of an origin: rr, c = rr - r^2, K (rr + r^2), M rr
// (may_hit reads the last three; rr makes them one 16-byte load for K3).
__device__ __forceinline__ void origin_consts(const float* ro, float r2, float* k) {
  const float rr = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2];
  k[0] = rr;
  k[1] = rr - r2;
  k[2] = kKappa * (rr + r2);
  k[3] = kMu * rr;
}

// The lane's pre-test (object_may_hit_plain): false only where the line ro +
// s d, s >= 0, provably misses the bounding ball, so the full test's valid
// is false. k: origin_consts of ro.
__device__ __forceinline__ bool may_hit(const float* ro, const float* d, const float* k) {
  const float rd = ro[0] * d[0] + ro[1] * d[1] + ro[2] * d[2];
  const float dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float disc = rd * rd - dd * k[1];
  // bitwise & and |: no branches, every comparison evaluated
  const bool dead = isfinite(disc) & (dd >= kDdMin) &
                    ((disc < -(dd * k[2])) | ((rd > 0.0f) & (k[1] > k[3])));
  return !dead;
}

// Stage the G rows into s_p; with s_k, also each row's origin_consts (K3).
__device__ __forceinline__ void stage_params(const float* params, int G, int n_spheres,
                                             float* s_p, float* s_k) {
  for (int e = threadIdx.x; e < G * kCols; e += blockDim.x) s_p[e] = params[e];
  __syncthreads();
  if (s_k != nullptr) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      origin_consts(s_p + g * kCols + 12, bound_r2(g < n_spheres), s_k + g * kConsts);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
analytic_nearest_kernel(const float* __restrict__ params, int n_spheres, int n_cubes,
                        const float* __restrict__ dir4, int n, float* __restrict__ t_out,
                        int* __restrict__ obj_out, float* __restrict__ nrm_out,
                        float* __restrict__ uv_out, int* __restrict__ tested) {
  extern __shared__ float4 s_p4[];  // 16-byte aligned rows
  float* s_p = reinterpret_cast<float*>(s_p4);
  const int G = n_spheres + n_cubes;
  float* s_k = s_p + G * kCols;
  stage_params(params, G, n_spheres, s_p, s_k);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;  // lanes past n vote no and store nothing
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = dir4[static_cast<size_t>(k) * n + lane];
  }

  float best_t = rpt::kInf, best_obj = 0.0f, best_kind = 0.0f;
  float bn[3] = {0.0f, 0.0f, 0.0f}, bs[3] = {0.0f, 0.0f, 0.0f};
  for (int g = 0; g < G; ++g) {
    const float* p = s_p + g * kCols;
    const bool is_sphere = g < n_spheres;
    const float4 ro4 = *reinterpret_cast<const float4*>(p + 12);
    const float4 k4 = *reinterpret_cast<const float4*>(s_k + g * kConsts);
    const float ro[3] = {ro4.x, ro4.y, ro4.z}, kc[kConsts] = {k4.x, k4.y, k4.z, k4.w};
    float d[3];
    apply34(p, w, d);
    if (!__any_sync(kFull, live & may_hit(ro, d, kc))) continue;
    if (tested != nullptr && (threadIdx.x & 31) == 0) atomicAdd(tested, 1);
    const float scale = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dh[3] = {d[0] / scale, d[1] / scale, d[2] / scale};
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
  if (!live) return;
  t_out[lane] = best_t;
  obj_out[lane] = static_cast<int>(best_obj);
#pragma unroll
  for (int k = 0; k < 3; ++k) nrm_out[static_cast<size_t>(k) * n + lane] = bn[k];
  if (best_t == rpt::kInf) {  // no hit: bs is 0, and atan2(0, 0) = asin(0) = 0
    uv_out[lane] = 0.5f;
    uv_out[n + lane] = 0.5f;
  } else if (best_kind == 0.0f) {
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
                      const float* __restrict__ tmax, int n, float* __restrict__ t_out,
                      int* __restrict__ tested) {
  extern __shared__ float4 s_p4[];  // 16-byte aligned rows
  float* s_p = reinterpret_cast<float*>(s_p4);
  const int G = n_spheres + n_cubes;
  stage_params(params, G, n_spheres, s_p, nullptr);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  // a masked lane (tmax == 0: its result is not read) or one past n votes no
  const bool active = lane < n && tmax[lane] != 0.0f;
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = dir4[static_cast<size_t>(k) * n + lane];
      o[k] = o4[static_cast<size_t>(k) * n + lane];
    }
  }
  float best = rpt::kInf;
  // a warp with no active lane would vote no on every object: it skips the walk
  const int walk = __any_sync(kFull, active) ? G : 0;
  for (int g = 0; g < walk; ++g) {
    const float* p = s_p + g * kCols;
    float d[3], ro[3], k[kConsts];
    apply34(p, w, d);
    apply34(p, o, ro);
#pragma unroll
    for (int j = 0; j < 3; ++j) ro[j] = ro[j] + p[12 + j];
    origin_consts(ro, bound_r2(g < n_spheres), k);
    if (!__any_sync(kFull, active & may_hit(ro, d, k))) continue;
    if (tested != nullptr && (threadIdx.x & 31) == 0) atomicAdd(tested, 1);
    const float scale = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dh[3] = {d[0] / scale, d[1] / scale, d[2] / scale};
    bool valid;
    float nin[3];
    const float dist = g < n_spheres ? sphere_hit(ro, dh, &valid) : cube_hit(ro, dh, &valid, nin);
    const float t = valid ? dist / scale : rpt::kInf;
    best = (t < best || isnan(t)) ? t : best;  // jnp.minimum: NaN propagates
  }
  if (lane < n) t_out[lane] = active ? best : rpt::kInf;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int rpt_analytic_nearest(const void* params, int n_spheres, int n_cubes,
                                    const void* dir4, int n, void* t, void* obj, void* nrm,
                                    void* uv, void* tested, void* stream) {
  const size_t smem =
      static_cast<size_t>(n_spheres + n_cubes) * (kCols + kConsts) * sizeof(float);
  if (const int e = set_smem(reinterpret_cast<const void*>(analytic_nearest_kernel), smem)) {
    return e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  analytic_nearest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), n_spheres, n_cubes,
      static_cast<const float*>(dir4), n, static_cast<float*>(t), static_cast<int*>(obj),
      static_cast<float*>(nrm), static_cast<float*>(uv), static_cast<int*>(tested));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_analytic_min_t(const void* params, int n_spheres, int n_cubes,
                                  const void* o4, const void* dir4, const void* tmax, int n,
                                  void* t, void* tested, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n_spheres + n_cubes) * kCols * sizeof(float);
  if (const int e = set_smem(reinterpret_cast<const void*>(analytic_min_t_kernel), smem)) {
    return e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  analytic_min_t_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), n_spheres, n_cubes, static_cast<const float*>(o4),
      static_cast<const float*>(dir4), static_cast<const float*>(tmax), n,
      static_cast<float*>(t), static_cast<int*>(tested));
  return static_cast<int>(cudaGetLastError());
}
