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
// Both walks use one CUDA block per 1024-ray block (the JAX package's ray
// block, so block b's live list is the same array in both packages), walk
// the list front to back, and stop at the first chunk whose floor is not
// below the block's bound `mb`; `mb` is a block-wide max that every thread
// reads after a barrier, so all take the same loop decision. Acceptance uses
// the TPU's form: one reciprocal 1/det, then u = u_num * inv, v = v_num *
// inv, dist = ct * inv, with -fmad=false, so edge pixels decide as on the
// TPU. The TPU's chunk pairing (a fix for TPU loop overhead) is not copied:
// it never changes results.
//
// The shared walk (K5, K11). What bounds it on this card: arithmetic and the
// walk's length, not memory. A live chunk costs each ray 32 ray/triangle
// tests (about 30 fp32 operations and one IEEE division each) against 320
// bytes of constants that the whole block shares; rays, lists and outputs
// are read and written once. 256 threads own 4 rays each, kept in registers
// for the whole walk. For each live chunk the block stages the chunk's
// constants in shared memory and every thread tests its rays against all 32
// triangles (broadcast reads, no bank conflicts); the walk bound is a
// shared-memory max-reduce, so a block advances only as fast as its slowest
// warp. It loads the winner's 15 attributes as one fp32 row at the end,
// where the TPU selects them with hi/lo bf16 one-hot products (those carry
// about |x| * 2^-16).
//
// The shadow walk (K6, K12). Most lanes cast no shadow ray: the renderer
// masks them with tmax = 0. Such a lane needs no test: its result
// min(bt, tmax) is tmax whatever it hits, since an accepted distance is
// >= 0, and it adds nothing to the walk bound, since its term
// min(bt, teff) <= tmax <= 0 and the bound starts at 0. So this walk tests
// only the lanes with tmax > 0 ("active"), and its output equals the twin's
// (walk_general_lists, which tests every lane) bit for bit. What bounds it
// on this card: the active lanes' tests (about 47 fp32 operations and one
// IEEE division each) and the walk's length. Shadow lanes crowd into the
// blocks that see a mesh (chip_smoke.py prints how many walk and their
// tests), and the walk is serial per block, so the longest block sets the
// kernel's end: on the large demo path one block holds about a quarter of
// all the tests. The design spreads
// each block over a cluster of 8 CTAs on 8 SMs (8 is the portable cluster
// size):
//   - Compaction at entry: each CTA reads tmax for the block's 1024 lanes (4
//     per thread); a warp scan of the counts and a prefix over the warps'
//     totals number the active lanes, the same in every CTA, and CTA r keeps
//     those numbered s with s % 8 == r: their 10 ray values, tcut and
//     teff = min(tmax, union-box exit) as three float4 in shared memory, with
//     the running min bt. A block with no active lane writes tmax and
//     returns without reading a ray or touching a cluster barrier.
//   - Mapping on (active ray x triangle): warp w of a CTA takes its rays w,
//     w + 8, ...; lane i holds triangle i of the chunk (its 80-byte row, 20
//     floats) in registers and tests it against the ray, whose values every
//     lane reads from one shared address (a broadcast). A ray's chunk min is
//     one warp reduction, __reduce_min_sync on the float bits: an accepted
//     distance is >= 0 or -0.0, fabsf makes it a non-negative float, and
//     those order as their bits. A warp tests 4 rays at once, the sums of
//     the 4 first (no branches, so they interleave), then the divisions.
//   - The bound: each warp pushes the max of its rays' bound terms into
//     every CTA of the cluster (remote shared stores, which do not wait);
//     after one cluster barrier each CTA reads its own copy, so every thread
//     of the cluster takes the same loop decision. The barrier is split:
//     between arrive and wait the warps test the next chunk of the list as
//     if it will be walked, into the other half of a double-buffered bt, and
//     keep that half only if the bound says so. So the barrier's latency,
//     which a walk of few active lanes would otherwise pay per chunk, hides
//     behind the tests.
//   - The next candidate's row is loaded while the current one is tested:
//     the cursor knows it before any bound decides about it (reading it is
//     harmless if it is not walked).
//   - The list lives in shared memory: at entry each CTA copies its block's
//     live list (ids and floors; for K12 the live superchunk ids, their
//     floors and the block's bit row), and every thread runs the same cursor
//     over those copies. K12's cursor walks a live super's bit words with
//     __ffs (S = 32 is one word, S = 128 four); it yields the chunks in the
//     position order of the TPU's cursor, so results do not change.
// No tensor cores: the 19 products of a test are exact fp32 sums, left to
// right, and TF32 (or 3xTF32 emulation) would give other bits; the JAX
// package's reduced-precision products broke oracle parity. The walk uses
// the SM's fp32 units, shared and distributed shared memory, warp
// reductions, cluster barriers and register-staged loads.
//
// One template serves both tiers of each walk; only the list it is fed
// differs (the `List` parameter):
//   FlatList   (K5, K6): chunk ids in front-to-back order; stop at the first
//              chunk whose floor is not below the block bound.
//   SuperList  (K11, K12): superchunk ids in front-to-back order; a cursor
//              runs over the positions of the live supers (S chunks each),
//              skips the chunks whose liveness bit is clear, and stops at the
//              first live chunk whose super's floor is not below the bound.
// The TPU streams the large tier's per-chunk records from HBM into VMEM with
// double-buffered DMAs because its VMEM cannot hold them; here every chunk is
// read from device memory as in K5/K6 (the row layouts are the same), so the
// large tier needs no records of its own. Triangles at or past the real count
// T are masked as on the TPU (mesh_large.py:226); K5/K6 test whole chunks
// (their zero pad rows fail the det test anyway).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = rpt::kNB / kThreads;  // rays per thread
constexpr int kShRow = 10;  // shared triangle row: det(3) u(3) v(3) ct
constexpr int kGenRow = 20;  // general triangle row: det(3) u(6) v(6) t(4) pad
constexpr int kAttr = 15;

// The shadow walk: a cluster of kGenCluster CTAs per 1024-ray block, each of
// 8 warps; at entry each thread owns kGenLanes lanes of the block, and each
// CTA keeps at most kGenSlots of its active lanes.
constexpr int kGenCluster = 8;
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kGenLanes = rpt::kNB / kGenThreads;
constexpr int kGenSlots = rpt::kNB / kGenCluster;
constexpr int kGenBatch = 4;  // rays a warp tests at once

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

  // The shadow walk's copy of block b's list in shared memory: the live
  // chunk ids in walk order, then their floors (stage_words() 32-bit words).
  size_t stage_words() const { return 2 * static_cast<size_t>(n_chunks); }

  __device__ void stage(int b, int* s) const {
    const size_t row = static_cast<size_t>(b) * n_chunks;
    float* fl = reinterpret_cast<float*>(s + n_chunks);
    for (int e = threadIdx.x; e < counts[b]; e += blockDim.x) {
      const int c = order[row + e];
      s[e] = c;
      fl[e] = minds[row + c];
    }
  }

  // Yields the next chunk of the list and its floor; the caller stops on the
  // floor.
  struct Cursor {
    const int* ids;
    const float* fl;
    int n_live;
    int j;

    __device__ bool advance(int* k, float* floor_out) {
      if (j >= n_live) return false;
      *k = ids[j];
      *floor_out = fl[j];
      ++j;
      return true;
    }
  };

  __device__ Cursor cursor(int b, const int* s) const {
    return Cursor{s, reinterpret_cast<const float*>(s + n_chunks), counts[b], 0};
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

  // The shadow walk's copy in shared memory: the live super ids in walk
  // order, their floors, then block b's bit row. S is a multiple of 32.
  size_t stage_words() const { return 2 * static_cast<size_t>(n_super) + n_words; }

  __device__ void stage(int b, int* s) const {
    const size_t row = static_cast<size_t>(b) * n_super;
    float* fl = reinterpret_cast<float*>(s + n_super);
    for (int e = threadIdx.x; e < counts[b]; e += blockDim.x) {
      const int sp = order[row + e];
      s[e] = sp;
      fl[e] = minds[row + sp];
    }
    const int* bw = bits + static_cast<size_t>(b) * n_words;
    for (int w = threadIdx.x; w < n_words; w += blockDim.x) s[2 * n_super + w] = bw[w];
  }

  // Word-at-a-time cursor: `mask` holds the live chunks of the current bit
  // word still to yield (bits of chunks at or past C cleared); __ffs takes
  // the lowest, so chunks come in position order.
  struct Cursor {
    const int* sup;
    const float* fl;
    const int* bw;
    int n_live;
    int words_per_super;
    int n_words;
    int C;
    int sp;
    int wq;
    int wbase;
    unsigned mask;

    __device__ bool advance(int* k, float* floor_out) {
      while (mask == 0u) {
        if (++wq == words_per_super) {
          wq = 0;
          ++sp;
        }
        if (sp >= n_live) return false;
        const int w = sup[sp] * words_per_super + wq;
        wbase = w * 32;
        const int below_c = C - wbase;  // chunks of this word below C
        mask = (w < n_words && below_c > 0) ? static_cast<unsigned>(bw[w]) : 0u;
        if (below_c < 32) mask &= below_c > 0 ? (1u << below_c) - 1u : 0u;
      }
      *k = wbase + __ffs(mask) - 1;
      mask &= mask - 1u;
      *floor_out = fl[sp];
      return true;
    }
  };

  __device__ Cursor cursor(int b, const int* s) const {
    return Cursor{s, reinterpret_cast<const float*>(s + n_super), s + 2 * n_super, counts[b],
                  S / 32, n_words, C, 0, -1, 0, 0u};
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

// Lane `lane`'s triangle row of chunk k: five 16-byte loads.
__device__ __forceinline__ void load_row(const float4* __restrict__ rows4, int k, int lane,
                                         float* c) {
  const float4* src = rows4 + (static_cast<size_t>(k) * rpt::kTC + lane) * (kGenRow / 4);
#pragma unroll
  for (int i = 0; i < kGenRow / 4; ++i) {
    const float4 q = src[i];
    c[4 * i] = q.x;
    c[4 * i + 1] = q.y;
    c[4 * i + 2] = q.z;
    c[4 * i + 3] = q.w;
  }
}

// Max over the cluster of the warp values each CTA left in its own `half`
// (the walk's first bound): each lane reads kGenCluster * kGenWarps / 32 of
// them from the CTAs that hold them, then a warp reduction, so every thread
// of the cluster gets the same value (the values are >= 0).
__device__ __forceinline__ float cluster_max(cooperative_groups::cluster_group& cluster,
                                             float* half, int lane) {
  float m = 0.0f;
#pragma unroll
  for (int e = lane; e < kGenCluster * kGenWarps; e += 32) {
    m = fmaxf(m, cluster.map_shared_rank(half, e / kGenWarps)[e % kGenWarps]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// Max of the kGenCluster * kGenWarps warp values pushed into this CTA's
// `all` (the walk's per-chunk bound): local reads and a warp reduction.
__device__ __forceinline__ float pushed_max(const float* all, int lane) {
  float m = 0.0f;
#pragma unroll
  for (int e = lane; e < kGenCluster * kGenWarps; e += 32) m = fmaxf(m, all[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// The cluster barrier in two halves (sm_90): arrive publishes this thread's
// earlier writes, wait returns once every thread of the cluster arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This warp's rays against chunk k, lane i holding triangle i's row in c:
// each ray's running min goes from bt_in to bt_out; returns the max of the
// rays' bound terms.
template <bool kMaskTail>
__device__ __forceinline__ float test_chunk(const float* c, int k, int T,
                                            const float4* s_ray, const float* bt_in,
                                            float* bt_out, int n_mine, int warp, int lane) {
  const bool tri_live = !kMaskTail || lane < T - k * rpt::kTC;
  float wmax = 0.0f;
  // kGenBatch rays at a time, general_tri_test split in two: the rays' sums
  // (most of the work, no branches) interleave; the divisions, whose
  // IEEE slow path is a branch, follow one ray after another.
  for (int a0 = warp; a0 < n_mine; a0 += kGenWarps * kGenBatch) {
    float det[kGenBatch], un[kGenBatch], vn[kGenBatch], tn[kGenBatch];
    float tcut[kGenBatch], teff[kGenBatch];
#pragma unroll
    for (int r = 0; r < kGenBatch; ++r) {
      const int a = min(a0 + r * kGenWarps, n_mine - 1);  // past the end: a copy
      const float4 p0 = s_ray[3 * a], p1 = s_ray[3 * a + 1], p2 = s_ray[3 * a + 2];
      const float x[10] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y};
      rpt::general_tri_sums(c, x, &det[r], &un[r], &vn[r], &tn[r]);
      tcut[r] = p2.z;
      teff[r] = p2.w;
    }
    unsigned key[kGenBatch];
#pragma unroll
    for (int r = 0; r < kGenBatch; ++r) {
      float u, v, dist;
      const bool ok = rpt::mt_accept(det[r], un[r], vn[r], tn[r], &u, &v, &dist) && tri_live;
      key[r] = __float_as_uint(ok ? fabsf(dist) : rpt::kInf);
    }
#pragma unroll
    for (int r = 0; r < kGenBatch; ++r) key[r] = __reduce_min_sync(0xffffffffu, key[r]);
#pragma unroll
    for (int r = 0; r < kGenBatch; ++r) {
      const int a = a0 + r * kGenWarps;
      if (a >= n_mine) break;
      const float bt = fminf(bt_in[a], __uint_as_float(key[r]));
      if (lane == 0) bt_out[a] = bt;
      // A lane holding a hit below tcut is occluded whatever lies nearer:
      // it stops extending the block's bound.
      wmax = fmaxf(wmax, bt < tcut[r] ? 0.0f : fminf(bt, teff[r]));
    }
  }
  __syncwarp();  // lane 0's bt_out before the warp reads it
  return wmax;
}

// The shadow walk; see the note at the head of this file. Dynamic shared
// memory: the list's stage_words() words.
template <class List>
__global__ void __cluster_dims__(kGenCluster, 1, 1) __launch_bounds__(kGenThreads)
general_walk_kernel(List list, const float* __restrict__ box, const float* __restrict__ rows,
                    const float* __restrict__ r10, const float* __restrict__ tmax2, int n,
                    int T, float* __restrict__ t_out) {
  static_assert(kGenCluster * kGenWarps % 32 == 0, "cluster_max reads whole warps of values");
  // per slot [d(3) m0] [m1 m2 o0 o1] [o2 x9 tcut teff], and its running min bt
  __shared__ float4 s_ray[3 * kGenSlots];
  __shared__ float s_bt[2][kGenSlots];  // two halves, see the walk
  __shared__ int s_count[kGenWarps];
  __shared__ float s_first[kGenWarps];  // warp values of the first bound
  // every warp value of the cluster, pushed by its warp; two halves
  __shared__ float s_all[2][kGenCluster * kGenWarps];
  extern __shared__ int s_list[];         // List::stage
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kGenCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = static_cast<size_t>(b) * rpt::kNB;

  // --- compaction: slots for the lanes with tmax > 0 ------------------------
  // Every CTA of the cluster numbers the block's active lanes the same way
  // and keeps those whose slot s has s % kGenCluster == rank, at s / kGenCluster.
  unsigned act = 0u;  // bit q: lane q * kGenThreads + tid is active
  float tm[kGenLanes];
#pragma unroll
  for (int q = 0; q < kGenLanes; ++q) {
    tm[q] = tmax2[blk + q * kGenThreads + tid];
    if (tm[q] > 0.0f) act |= 1u << q;
  }
  const int mine = __popc(act);
  int incl = mine;  // inclusive scan of the counts over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_count[warp] = incl;
  __syncthreads();
  int slot = incl - mine, n_act = 0;
#pragma unroll
  for (int w = 0; w < kGenWarps; ++w) {
    slot += w < warp ? s_count[w] : 0;
    n_act += s_count[w];
  }
  const int first_slot = slot;
  if (n_act == 0) {  // nothing to test: every lane's result is its tmax
    if (rank == 0) {
#pragma unroll
      for (int q = 0; q < kGenLanes; ++q) t_out[blk + q * kGenThreads + tid] = tm[q];
    }
    return;  // the whole cluster returns here, before any cluster barrier
  }

  list.stage(b, s_list);
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kGenLanes; ++q) {
    if (!((act >> q) & 1u)) continue;
    if (slot % kGenCluster == rank) {
      const size_t li = blk + q * kGenThreads + tid;
      const int s = slot / kGenCluster;
      float r[10];
#pragma unroll
      for (int c = 0; c < 10; ++c) r[c] = r10[static_cast<size_t>(c) * n + li];
      // Walk bound min(tmax, union-box exit): no occluder lies beyond the box.
      const float teff =
          fminf(tm[q], rpt::box_bound(lo, hi, r[6], r[7], r[8], r[0], r[1], r[2]));
      s_ray[3 * s] = make_float4(r[0], r[1], r[2], r[3]);
      s_ray[3 * s + 1] = make_float4(r[4], r[5], r[6], r[7]);
      s_ray[3 * s + 2] = make_float4(r[8], r[9], tmax2[n + li], teff);
      s_bt[0][s] = rpt::kInf;
      local = fmaxf(local, teff);
    }
    ++slot;
  }
  const int n_mine = (n_act - rank + kGenCluster - 1) / kGenCluster;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  }
  if (lane == 0) s_first[warp] = local;
  // slots, lists and the first bound are in place, and every CTA of the
  // cluster runs before any touches another's shared memory
  cluster.sync();
  float mb = cluster_max(cluster, s_first, lane);

  // --- the walk -------------------------------------------------------------
  // Chunk j's bound goes out with a split cluster barrier: while it
  // completes, the warps test candidate j + 1 as if it will be walked, into
  // the other half of s_bt, and the half that holds the walked chunks flips
  // only if the bound says the candidate is walked.
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  typename List::Cursor cursor = list.cursor(b, s_list);
  const bool has_rays = warp < n_mine;
  int cur = 0;  // s_bt[cur]: each ray's min over the walked chunks
  int k, kn;
  float fl, fl_next;
  if (cursor.advance(&k, &fl) && fl < mb) {  // the same decision in every CTA
    float c[kGenRow], cn[kGenRow];
    if (has_rays) load_row(rows4, k, lane, c);
    bool more = cursor.advance(&kn, &fl_next);
    if (has_rays && more) load_row(rows4, kn, lane, cn);
    float wmax = has_rays ? test_chunk<List::kMaskTail>(c, k, T, s_ray, s_bt[0], s_bt[1],
                                                        n_mine, warp, lane)
                          : 0.0f;
    cur = 1;
    int par = 1;
    while (true) {
      // Lane r pushes the warp's value into CTA r's s_all (stores do not
      // wait), so after the barrier each CTA reads its own copy. Two
      // alternating halves: a half is written again only after the next
      // barrier, which every reader of it has passed.
      if (lane < kGenCluster) {
        cluster.map_shared_rank(s_all[par], lane)[rank * kGenWarps + warp] = wmax;
      }
      cluster_arrive();
      int k2 = 0;
      float fl2 = 0.0f, wnext = 0.0f;
      bool more2 = false;
      if (more) {
        k = kn;
#pragma unroll
        for (int e = 0; e < kGenRow; ++e) c[e] = cn[e];
        more2 = cursor.advance(&k2, &fl2);
        // the next candidate's row, before any bound decides about it
        if (has_rays && more2) load_row(rows4, k2, lane, cn);
        if (has_rays) {
          wnext = test_chunk<List::kMaskTail>(c, k, T, s_ray, s_bt[cur], s_bt[cur ^ 1], n_mine,
                                              warp, lane);
        }
      }
      cluster_wait();
      mb = pushed_max(s_all[par], lane);
      par ^= 1;
      if (!more || !(fl_next < mb)) break;  // the candidate's tests are dropped
      cur ^= 1;
      wmax = wnext;
      kn = k2;
      fl_next = fl2;
      more = more2;
    }
  }
  cluster.sync();  // s_first stays until the cluster has read it

  // --- results: min(bt, tmax) on active lanes, tmax on the others ---------
  slot = first_slot;
#pragma unroll
  for (int q = 0; q < kGenLanes; ++q) {
    const size_t li = blk + q * kGenThreads + tid;
    if ((act >> q) & 1u) {
      if (slot % kGenCluster == rank) t_out[li] = fminf(s_bt[cur][slot / kGenCluster], tm[q]);
      ++slot;
    } else if (rank == 0) {
      t_out[li] = tm[q];
    }
  }
}

// Launch general_walk_kernel<List>, one cluster per 1024-ray block, with the
// shared memory its list needs (allowed past the 48 KB default once per
// process).
template <class List>
int launch_general_walk(const List& list, const void* box, const void* rows, const void* r10,
                        const void* tmax2, int n, int T, void* t, void* stream) {
  static int max_bytes = -1;
  if (max_bytes < 0) {
    // the opt-in limit covers static and dynamic shared memory together
    int dev = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, general_walk_kernel<List>);
    const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(general_walk_kernel<List>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    max_bytes = dynamic;
  }
  const size_t bytes = 4 * list.stage_words();
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  general_walk_kernel<<<n / rpt::kNB * kGenCluster, kGenThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(rows),
      static_cast<const float*>(r10), static_cast<const float*>(tmax2), n, T,
      static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
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
  return launch_general_walk(list, box, rows, r10, tmax2, n, n_chunks * rpt::kTC, t, stream);
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
  if (S <= 0 || S % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);  // whole bit words
  const SuperList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                       static_cast<const int*>(counts), static_cast<const int*>(bits),
                       n_super, n_words, S, C};
  return launch_general_walk(list, box, rows, r10, tmax2, n, T, t, stream);
}

extern "C" const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
