// K5 and K6: the mesh walks over per-block live-chunk lists.
//
// Replaces relativitypathtracer_tpu/ops/pallas/mesh_kernels.py:
//   _shared_kernel  (K5, wrapper shared_nearest_hit): nearest triangle hit of
//                   primary rays that share one origin;
//   _general_kernel (K6, wrapper general_min_t): min hit distance of shadow
//                   rays with per-lane origins, bounded by tmax, with
//                   occlusion retirement below tcut.
//
// What bounds them on this card: arithmetic and the walk's length, not
// memory. A live chunk costs each ray 32 ray/triangle tests (about 30 fp32
// operations and one IEEE division each) against 320 (K5) or 640 (K6) bytes
// of constants that the whole block shares; rays, lists and outputs are read
// and written once. The block-wide early-termination test needs every lane's
// bound, so a block advances only as fast as its slowest warp.
//
// Design: one CUDA block per 1024-ray block (the JAX package's ray block, so
// block b's live list is the same array in both packages); 256 threads own
// 4 rays each, kept in registers for the whole walk. For each live chunk,
// front to back, the block stages the chunk's constants in shared memory and
// every thread tests its rays against all 32 triangles (broadcast reads, no
// bank conflicts). The walk bound `mb` is a shared-memory max-reduce ending
// in __syncthreads(), so every thread reads the same `mb` and takes the same
// loop decision. The TPU's chunk pairing (a fix for TPU loop overhead) is not
// copied: it never changes results. Acceptance uses the TPU's form: one
// reciprocal 1/det, then u = u_num * inv, v = v_num * inv, dist = ct * inv,
// with -fmad=false, so edge pixels decide as on the TPU. K5 loads the
// winner's 15 attributes as one fp32 row at the end, where the TPU selects
// them with hi/lo bf16 one-hot products (those carry about |x| * 2^-16).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = rpt::kNB / kThreads;  // rays per thread
constexpr int kShRow = 10;  // K5 triangle row: det(3) u(3) v(3) ct
constexpr int kGenRow = 20;  // K6 triangle row: det(3) u(6) v(6) t(4) pad
constexpr int kAttr = 15;

__global__ void __launch_bounds__(kThreads)
shared_walk_kernel(const int* __restrict__ order, const float* __restrict__ minds,
                   const int* __restrict__ counts, const float* __restrict__ box,
                   const float* __restrict__ tri, const float* __restrict__ attrs,
                   const float* __restrict__ dh, int n, int n_chunks,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ tri_out,
                   float* __restrict__ attr_out) {
  __shared__ float s_tri[rpt::kTC * kShRow];
  __shared__ float s_red[kThreads / 32];
  const int b = blockIdx.x;
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  const float ox = box[6], oy = box[7], oz = box[8];

  float dx[kRays], dy[kRays], dz[kRays], bound[kRays];
  float bt[kRays], bu[kRays], bv[kRays];
  int btri[kRays];
  float local = 0.0f;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int lane = b * rpt::kNB + r * kThreads + threadIdx.x;
    dx[r] = dh[lane];
    dy[r] = dh[n + lane];
    dz[r] = dh[2 * n + lane];
    bound[r] = rpt::box_bound(lo, hi, ox, oy, oz, dx[r], dy[r], dz[r]);
    bt[r] = rpt::kInf;
    bu[r] = 0.0f;
    bv[r] = 0.0f;
    btri[r] = -1;
    local = fmaxf(local, bound[r]);
  }
  // Start from the block's true bound: a block whose lanes all miss the
  // union box (bound 0) walks no chunk.
  float mb = rpt::block_max<kThreads>(local, s_red);

  const int n_live = counts[b];
  const int* ord = order + static_cast<size_t>(b) * n_chunks;
  const float* md = minds + static_cast<size_t>(b) * n_chunks;
  for (int j = 0; j < n_live; ++j) {
    const int k = ord[j];
    // Strict <: a hit at dist == mb cannot beat any lane's min(best, bound).
    if (!(md[k] < mb)) break;
    __syncthreads();  // the previous chunk's readers are done
    const float* src = tri + static_cast<size_t>(k) * rpt::kTC * kShRow;
    for (int e = threadIdx.x; e < rpt::kTC * kShRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    local = 0.0f;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      float dmin = rpt::kInf, umin = 0.0f, vmin = 0.0f;
      int imin = 0;
      for (int i = 0; i < rpt::kTC; ++i) {
        const float* c = s_tri + i * kShRow;
        const float det = c[0] * dx[r] + c[1] * dy[r] + c[2] * dz[r];
        const float un = c[3] * dx[r] + c[4] * dy[r] + c[5] * dz[r];
        const float vn = c[6] * dx[r] + c[7] * dy[r] + c[8] * dz[r];
        const float inv = 1.0f / det;
        const float u = un * inv;
        const float v = vn * inv;
        const float dist = c[9] * inv;
        const bool ok = fabsf(det) >= rpt::kEps && u >= 0.0f && u <= 1.0f &&
                        v >= 0.0f && u + v <= 1.0f && dist >= 0.0f;
        // strict <: the first minimum wins, as jnp.argmin
        if (ok && dist < dmin) {
          dmin = dist;
          umin = u;
          vmin = v;
          imin = i;
        }
      }
      if (dmin < bt[r]) {
        bt[r] = dmin;
        bu[r] = umin;
        bv[r] = vmin;
        btri[r] = k * rpt::kTC + imin;
      }
      local = fmaxf(local, fminf(bt[r], bound[r]));
    }
    mb = rpt::block_max<kThreads>(local, s_red);
  }

#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int lane = b * rpt::kNB + r * kThreads + threadIdx.x;
    t_out[lane] = bt[r];
    u_out[lane] = bu[r];
    v_out[lane] = bv[r];
    tri_out[lane] = btri[r];
    const float* row = attrs + static_cast<size_t>(btri[r] < 0 ? 0 : btri[r]) * kAttr;
#pragma unroll
    for (int a = 0; a < kAttr; ++a) {
      attr_out[static_cast<size_t>(a) * n + lane] = btri[r] < 0 ? 0.0f : row[a];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
general_walk_kernel(const int* __restrict__ order, const float* __restrict__ minds,
                    const int* __restrict__ counts, const float* __restrict__ box,
                    const float* __restrict__ rows, const float* __restrict__ r10,
                    const float* __restrict__ tmax2, int n, int n_chunks,
                    float* __restrict__ t_out) {
  __shared__ float s_tri[rpt::kTC * kGenRow];
  __shared__ float s_red[kThreads / 32];
  const int b = blockIdx.x;
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};

  float r[kRays][10];
  float tmax[kRays], tcut[kRays], teff[kRays], bt[kRays];
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int lane = b * rpt::kNB + q * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 10; ++c) r[q][c] = r10[static_cast<size_t>(c) * n + lane];
    tmax[q] = tmax2[lane];
    tcut[q] = tmax2[n + lane];
    // Walk bound min(tmax, union-box exit): no occluder lies beyond the box.
    teff[q] = fminf(tmax[q], rpt::box_bound(lo, hi, r[q][6], r[q][7], r[q][8],
                                            r[q][0], r[q][1], r[q][2]));
    bt[q] = rpt::kInf;
    local = fmaxf(local, teff[q]);
  }
  // Blocks whose lanes are all masked (tmax 0) walk no chunk.
  float mb = rpt::block_max<kThreads>(local, s_red);

  const int n_live = counts[b];
  const int* ord = order + static_cast<size_t>(b) * n_chunks;
  const float* md = minds + static_cast<size_t>(b) * n_chunks;
  for (int j = 0; j < n_live; ++j) {
    const int k = ord[j];
    if (!(md[k] < mb)) break;
    __syncthreads();
    const float* src = rows + static_cast<size_t>(k) * rpt::kTC * kGenRow;
    for (int e = threadIdx.x; e < rpt::kTC * kGenRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    local = 0.0f;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float cmin = rpt::kInf;
      for (int i = 0; i < rpt::kTC; ++i) {
        const float* c = s_tri + i * kGenRow;
        const float* x = r[q];
        const float det = c[0] * x[0] + c[1] * x[1] + c[2] * x[2];
        const float un = c[3] * x[0] + c[4] * x[1] + c[5] * x[2] + c[6] * x[3] +
                         c[7] * x[4] + c[8] * x[5];
        const float vn = c[9] * x[0] + c[10] * x[1] + c[11] * x[2] + c[12] * x[3] +
                         c[13] * x[4] + c[14] * x[5];
        const float tn = c[15] * x[6] + c[16] * x[7] + c[17] * x[8] + c[18] * x[9];
        const float inv = 1.0f / det;
        const float u = un * inv;
        const float v = vn * inv;
        const float dist = tn * inv;
        const bool ok = fabsf(det) >= rpt::kEps && u >= 0.0f && u <= 1.0f &&
                        v >= 0.0f && u + v <= 1.0f && dist >= 0.0f;
        if (ok) cmin = fminf(cmin, dist);
      }
      bt[q] = fminf(bt[q], cmin);
      // A lane holding a hit below tcut is occluded whatever lies nearer:
      // it stops extending the block's bound.
      local = fmaxf(local, bt[q] < tcut[q] ? 0.0f : fminf(bt[q], teff[q]));
    }
    mb = rpt::block_max<kThreads>(local, s_red);
  }

#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int lane = b * rpt::kNB + q * kThreads + threadIdx.x;
    t_out[lane] = fminf(bt[q], tmax[q]);
  }
}

}  // namespace

extern "C" int rpt_shared_walk(const void* order, const void* minds, const void* counts,
                               const void* box, const void* tri, const void* attrs,
                               const void* dh, int n, int n_chunks, void* t, void* u,
                               void* v, void* tri_out, void* attr, void* stream) {
  shared_walk_kernel<<<n / rpt::kNB, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(minds),
      static_cast<const int*>(counts), static_cast<const float*>(box),
      static_cast<const float*>(tri), static_cast<const float*>(attrs),
      static_cast<const float*>(dh), n, n_chunks, static_cast<float*>(t),
      static_cast<float*>(u), static_cast<float*>(v), static_cast<int*>(tri_out),
      static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_general_walk(const void* order, const void* minds, const void* counts,
                                const void* box, const void* rows, const void* r10,
                                const void* tmax2, int n, int n_chunks, void* t,
                                void* stream) {
  general_walk_kernel<<<n / rpt::kNB, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(minds),
      static_cast<const int*>(counts), static_cast<const float*>(box),
      static_cast<const float*>(rows), static_cast<const float*>(r10),
      static_cast<const float*>(tmax2), n, n_chunks, static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
