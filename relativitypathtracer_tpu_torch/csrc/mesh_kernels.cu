// K5, K6, K11 and K12: the mesh walks over per-block live-chunk lists.
//
// Replaces relativitypathtracer_tpu/ops/pallas/mesh_kernels.py:
//   _shared_kernel  (K5, wrapper shared_nearest_hit): nearest triangle hit of
//                   primary rays that share one origin;
//   _general_kernel (K6, wrapper general_min_t): min hit distance of shadow
//                   rays with per-lane origins, bounded by tmax, with
//                   occlusion retirement below tcut;
// and relativitypathtracer_tpu/ops/pallas/mesh_large.py, the large-mesh tier:
//   _shared_large_kernel  (K11, wrapper large_shared_nearest_hit) and
//   _general_large_kernel (K12, wrapper large_general_min_t): the same two
//                   walks over a superchunk-ordered list with a per-(block,
//                   chunk) liveness bitmask.
//
// What bounds them on this card: arithmetic and the walk's length, not
// memory. A live chunk costs each ray 32 ray/triangle tests (about 30 fp32
// operations and one IEEE division each) against 320 (shared) or 640
// (general) bytes of constants that the whole block shares; rays, lists and
// outputs are read and written once. The block-wide early-termination test
// needs every lane's bound, so a block advances only as fast as its slowest
// warp.
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
// with -fmad=false, so edge pixels decide as on the TPU. The shared walk
// loads the winner's 15 attributes as one fp32 row at the end, where the TPU
// selects them with hi/lo bf16 one-hot products (those carry about
// |x| * 2^-16).
//
// One walk serves both tiers; only the list it is fed differs (the `List`
// template parameter, whose `next` yields the next chunk to test or ends the
// walk):
//   FlatList   (K5, K6): chunk ids in front-to-back order; stop at the first
//              chunk whose floor is not below the block bound.
//   SuperList  (K11, K12): superchunk ids in front-to-back order; a cursor
//              runs over the positions of the live supers (S chunks each),
//              skips the chunks whose liveness bit is clear, and stops at the
//              first live chunk whose super's floor is not below the bound.
// The TPU streams the large tier's per-chunk records from HBM into VMEM with
// double-buffered DMAs because its VMEM cannot hold them; here every chunk is
// read from device memory into shared memory as in K5/K6 (the row layouts are
// the same), so the large tier needs no records of its own. Triangles at or
// past the real count T are masked as on the TPU (mesh_large.py:226); K5/K6
// test whole chunks (their zero pad rows fail the det test anyway), with a
// trip count the compiler knows, as before the large tier shared the walk.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = rpt::kNB / kThreads;  // rays per thread
constexpr int kShRow = 10;  // shared triangle row: det(3) u(3) v(3) ct
constexpr int kGenRow = 20;  // general triangle row: det(3) u(6) v(6) t(4) pad
constexpr int kAttr = 15;

// K5/K6 lists: order (B, C) chunk ids, minds (B, C) floors by chunk id,
// counts (B,) live chunks.
struct FlatList {
  static constexpr bool kMaskTail = false;  // every chunk holds kTC triangles to test
  const int* order;
  const float* minds;
  const int* counts;
  int n_chunks;

  struct Walk {
    const int* ord;
    const float* md;
    int n_live;
    int j;

    // Strict <: a hit at dist == mb cannot beat any lane's bound.
    __device__ bool next(float mb, int* k) {
      if (j >= n_live) return false;
      const int c = ord[j];
      if (!(md[c] < mb)) return false;
      ++j;
      *k = c;
      return true;
    }
  };

  __device__ Walk at(int b) const {
    const size_t row = static_cast<size_t>(b) * n_chunks;
    return Walk{order + row, minds + row, counts[b], 0};
  }
};

// K11/K12 lists: order (B, C_s) super ids, minds (B, C_s) floors by super
// id, counts (B,) live supers, bits (B, W) liveness of chunk w * 32 + i in
// bit i of word w (bit 31 is the sign bit). A super holds S consecutive
// chunks; positions past the real chunk count C are dead (their bits are 0
// by construction; the c < C test keeps the read inside the row).
struct SuperList {
  static constexpr bool kMaskTail = true;  // triangles at or past T are masked
  const int* order;
  const float* minds;
  const int* counts;
  const int* bits;
  int n_super;
  int n_words;
  int S;
  int C;

  struct Walk {
    const int* ord;
    const float* md;
    const int* bw;
    int end;
    int S;
    int C;
    int p;

    __device__ bool next(float mb, int* k) {
      int c = 0;
      for (; p < end; ++p) {  // skip dead chunks
        c = ord[p / S] * S + p % S;
        if (c < C && ((bw[c >> 5] >> (c & 31)) & 1)) break;
      }
      if (p >= end) return false;
      if (!(md[ord[p / S]] < mb)) return false;
      ++p;
      *k = c;
      return true;
    }
  };

  __device__ Walk at(int b) const {
    const size_t row = static_cast<size_t>(b) * n_super;
    return Walk{order + row, minds + row, bits + static_cast<size_t>(b) * n_words,
                counts[b] * S, S, C, 0};
  }
};

template <class List>
__global__ void __launch_bounds__(kThreads)
shared_walk_kernel(List list, const float* __restrict__ box, const float* __restrict__ tri,
                   const float* __restrict__ attrs, const float* __restrict__ dh, int n, int T,
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

  typename List::Walk walk = list.at(b);
  int k;
  while (walk.next(mb, &k)) {
    __syncthreads();  // the previous chunk's readers are done
    const float* src = tri + static_cast<size_t>(k) * rpt::kTC * kShRow;
    for (int e = threadIdx.x; e < rpt::kTC * kShRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    // triangles below T; a compile-time kTC for K5/K6
    const int n_tri = List::kMaskTail ? min(rpt::kTC, T - k * rpt::kTC) : rpt::kTC;
    local = 0.0f;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      float dmin = rpt::kInf, umin = 0.0f, vmin = 0.0f;
      int imin = 0;
      for (int i = 0; i < n_tri; ++i) {
        float u, v, dist;
        const bool ok = rpt::shared_tri_test(s_tri + i * kShRow, dx[r], dy[r], dz[r],
                                             &u, &v, &dist);
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

template <class List>
__global__ void __launch_bounds__(kThreads)
general_walk_kernel(List list, const float* __restrict__ box, const float* __restrict__ rows,
                    const float* __restrict__ r10, const float* __restrict__ tmax2, int n,
                    int T, float* __restrict__ t_out) {
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

  typename List::Walk walk = list.at(b);
  int k;
  while (walk.next(mb, &k)) {
    __syncthreads();
    const float* src = rows + static_cast<size_t>(k) * rpt::kTC * kGenRow;
    for (int e = threadIdx.x; e < rpt::kTC * kGenRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    const int n_tri = List::kMaskTail ? min(rpt::kTC, T - k * rpt::kTC) : rpt::kTC;
    local = 0.0f;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float cmin = rpt::kInf;
      for (int i = 0; i < n_tri; ++i) {
        float dist;
        if (rpt::general_tri_test(s_tri + i * kGenRow, r[q], &dist)) cmin = fminf(cmin, dist);
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

cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

}  // namespace

extern "C" int rpt_shared_walk(const void* order, const void* minds, const void* counts,
                               const void* box, const void* tri, const void* attrs,
                               const void* dh, int n, int n_chunks, void* t, void* u,
                               void* v, void* tri_out, void* attr, void* stream) {
  const FlatList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                      static_cast<const int*>(counts), n_chunks};
  shared_walk_kernel<<<n / rpt::kNB, kThreads, 0, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(tri),
      static_cast<const float*>(attrs), static_cast<const float*>(dh), n,
      n_chunks * rpt::kTC, static_cast<float*>(t), static_cast<float*>(u),
      static_cast<float*>(v), static_cast<int*>(tri_out), static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_general_walk(const void* order, const void* minds, const void* counts,
                                const void* box, const void* rows, const void* r10,
                                const void* tmax2, int n, int n_chunks, void* t,
                                void* stream) {
  const FlatList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                      static_cast<const int*>(counts), n_chunks};
  general_walk_kernel<<<n / rpt::kNB, kThreads, 0, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(rows),
      static_cast<const float*>(r10), static_cast<const float*>(tmax2), n,
      n_chunks * rpt::kTC, static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_large_shared_walk(const void* order, const void* minds, const void* counts,
                                     const void* bits, const void* box, const void* tri,
                                     const void* attrs, const void* dh, int n, int n_super,
                                     int n_words, int S, int C, int T, void* t, void* u,
                                     void* v, void* tri_out, void* attr, void* stream) {
  const SuperList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                       static_cast<const int*>(counts), static_cast<const int*>(bits),
                       n_super, n_words, S, C};
  shared_walk_kernel<<<n / rpt::kNB, kThreads, 0, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(tri),
      static_cast<const float*>(attrs), static_cast<const float*>(dh), n, T,
      static_cast<float*>(t), static_cast<float*>(u), static_cast<float*>(v),
      static_cast<int*>(tri_out), static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_large_general_walk(const void* order, const void* minds, const void* counts,
                                      const void* bits, const void* box, const void* rows,
                                      const void* r10, const void* tmax2, int n, int n_super,
                                      int n_words, int S, int C, int T, void* t,
                                      void* stream) {
  const SuperList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                       static_cast<const int*>(counts), static_cast<const int*>(bits),
                       n_super, n_words, S, C};
  general_walk_kernel<<<n / rpt::kNB, kThreads, 0, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(rows),
      static_cast<const float*>(r10), static_cast<const float*>(tmax2), n, T,
      static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
