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
// Both walks take the JAX package's ray block of 1024 lanes (so block b's
// live list is the same array in both packages), walk the list front to
// back, and stop at the first chunk whose floor is not below the block's
// bound `mb` (strict <: a hit at dist == mb cannot beat any lane's bound),
// the max over the block's lanes of a term of their running min. Acceptance
// uses the TPU's form: one reciprocal 1/det, then u = u_num * inv, v = v_num
// * inv, dist = ct * inv, with -fmad=false, so edge pixels decide as on the
// TPU. The TPU's chunk pairing (a fix for TPU loop overhead) is not copied:
// it never changes results.
//
// What bounds both walks on this card: arithmetic and the walk's length, not
// memory. A walked chunk costs each tested ray 32 ray/triangle tests (about
// 29 fp32 operations and one IEEE division each for K5/K11, 47 for K6/K12)
// against rows that the block's rays share; rays, lists and outputs are read
// and written once. The work is uneven across blocks: only the blocks that
// see the mesh walk, and those on its silhouette, where a lane that misses
// keeps the bound at its union-box exit, walk longest. A block's walk is
// serial, so a block on one SM sets the kernel's end once it holds more than
// one SM's share of the work (on the large demo path K12's heaviest block
// holds 26% of its tests, K11's 3.1%, four SMs' share; chip_smoke.py prints
// the counts). The design spreads each block over a cluster of 8 CTAs on 8
// SMs (8 is the portable cluster size):
//   - Mapping on (ray x triangle): warp w of a CTA takes its rays w, w + 8,
//     ...; lane i holds triangle i of the chunk (its row in registers: 10
//     floats for K5/K11, 20 for K6/K12) and tests it against the ray, whose
//     values every lane reads from one shared address (a broadcast). A warp
//     tests 4 rays at once: the sums of the 4 first (no branches, so they
//     interleave), then the divisions, whose IEEE slow path is a branch.
//   - A ray's chunk min is one warp reduction, __reduce_min_sync on the
//     float bits: an accepted distance is >= 0 or -0.0, a rejected lane
//     holds INF, fabsf makes each a non-negative float, and those order as
//     their bits. The primary walk also needs the argmin: __ballot_sync of
//     the lanes at the min and __ffs take the lowest, the first minimum, as
//     jnp.argmin and the twin take it; the winner's dist, u and v come from
//     its lane by __shfl_sync (so a -0.0 distance stays -0.0), and only
//     where the chunk's min improves the ray, which the min alone tells.
//   - The bound: each warp pushes the max of its rays' bound terms into
//     every CTA of the cluster (remote shared stores, which do not wait);
//     after one cluster barrier each CTA reads its own copy, so every thread
//     of the cluster takes the same loop decision. The barrier is split:
//     between arrive and wait the warps test the next chunk of the list as
//     if it will be walked, into the other half of a double-buffered running
//     min (for K5/K11 the running t, u, v and triangle id), and keep that
//     half only if the bound says so. So the barrier's latency, which a walk
//     of few rays per CTA would otherwise pay per chunk, hides behind the
//     tests.
//   - The next candidate's row is loaded while the current one is tested:
//     the cursor knows it before any bound decides about it (reading it is
//     harmless if it is not walked).
//   - The list lives in shared memory: at entry each CTA copies the head of
//     its block's live list (ids and floors, up to 1,024 entries; for
//     K11/K12 up to 512 live superchunk ids with their floors and 512 words
//     of the block's bit row), and every thread runs the same cursor over
//     those copies, reading what lies past them from global memory. The
//     superchunk cursor walks a live super's bit words with __ffs (S = 32
//     is one word, S = 128 four); it yields the chunks in the position
//     order of the TPU's cursor, so results do not change.
//
// The primary walk (K5, K11). Every lane is a primary ray and is tested. CTA
// r of the cluster owns the block's lanes r * 128 ... r * 128 + 127: their
// direction and union-box bound in shared memory, with the running best.
// Every CTA computes the block's first bound (the max over all 1024 lanes)
// itself, so all take the first loop decision alike without a cluster
// barrier: a block whose lanes all miss the union box (bound 0) walks no
// chunk and writes t = INF, u = v = 0, tri = -1 and zero attributes. At the
// end each CTA writes its lanes' results and gathers each hit's 15-float
// attribute row (the TPU selects it with hi/lo bf16 one-hot products, which
// carry about |x| * 2^-16).
//
// The shadow walk (K6, K12). Most lanes cast no shadow ray: the renderer
// masks them with tmax = 0. Such a lane needs no test: its result
// min(bt, tmax) is tmax whatever it hits, since an accepted distance is
// >= 0, and it adds nothing to the walk bound, since its term
// min(bt, teff) <= tmax <= 0 and the bound starts at 0. So this walk tests
// only the lanes with tmax > 0 ("active"). Compaction at entry: each CTA
// reads tmax for the block's 1024 lanes (4 per thread); a warp scan of the
// counts and a prefix over the warps' totals number the active lanes, the
// same in every CTA, and CTA r keeps those numbered s with s % 8 == r: their
// 10 ray values, tcut and teff = min(tmax, union-box exit) as three float4
// in shared memory, with the running min bt. A block with no active lane
// writes tmax and returns without reading a ray or touching a cluster
// barrier.
//
// Exactness: each walk equals its twin (walk_shared_lists,
// walk_general_lists, which test every lane) bit for bit: the same fp32
// operations in the same order, the same argmin, and the same chunks walked,
// since every CTA computes the twin's bound (a max is exact in any order).
// No tensor cores: the 9 (K5/K11) or 19 (K6/K12) products of a test are
// exact fp32 sums, left to right, and TF32 (or 3xTF32 emulation) would give
// other bits; the JAX package's reduced-precision products broke oracle
// parity. The walks use the SM's fp32 units, shared and distributed shared
// memory, warp reductions, cluster barriers and register-staged loads.
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
#include <cstdint>

#include "walk.cuh"

namespace {

// K11/K12 lists: order (B, C_s) super ids, minds (B, C_s) floors by super
// id, counts (B,) live supers, bits (B, W) liveness of chunk w * 32 + i in
// bit i of word w (bit 31 is the sign bit). A super holds S consecutive
// chunks, S a multiple of 32; positions past the real chunk count C are dead.
// A mesh of any size walks, so shared memory holds a bounded head of a
// block's lists and the cursor reads what lies past it from global memory.
struct SuperList {
  static constexpr bool kMaskTail = true;  // triangles at or past T are masked
  // Supers (ids and floors) and bit words of a block staged in shared
  // memory: the whole lists of a mesh up to 16,384 chunks at S = 32 (the
  // large fixture's 320 supers among them).
  static constexpr int kStageMax = 512;
  static constexpr int kStageWordsMax = 512;
  static constexpr int kHead = 6;  // three global row pointers, first
  const int* order;
  const float* minds;
  const int* counts;
  const int* bits;
  int n_super;
  int n_words;
  int S;
  int C;

  __host__ __device__ int n_staged() const {
    return n_super < kStageMax ? n_super : kStageMax;
  }
  __host__ __device__ int n_words_staged() const {
    return n_words < kStageWordsMax ? n_words : kStageWordsMax;
  }

  // The copy in shared memory: block b's global rows of order, minds and
  // bits (three pointers), its first n_staged() live super ids in walk
  // order, their floors, then the first n_words_staged() words of its bit
  // row (stage_words() 32-bit words).
  size_t stage_words() const {
    return kHead + 2 * static_cast<size_t>(n_staged()) + n_words_staged();
  }

  __device__ void stage(int b, int* s) const {
    const size_t row = static_cast<size_t>(b) * n_super;
    const int n_st = n_staged(), n_wst = n_words_staged();
    int* ids = s + kHead;
    float* fl = reinterpret_cast<float*>(ids + n_st);
    int* bw = ids + 2 * n_st;
    const int n = counts[b] < n_st ? counts[b] : n_st;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int sp = order[row + e];
      ids[e] = sp;
      fl[e] = minds[row + sp];
    }
    const int* bits_row = bits + static_cast<size_t>(b) * n_words;
    for (int w = threadIdx.x; w < n_wst; w += blockDim.x) bw[w] = bits_row[w];
    if (threadIdx.x == 0) {
      const void** rows = reinterpret_cast<const void**>(s);
      rows[0] = order + row;
      rows[1] = minds + row;
      rows[2] = bits_row;
    }
  }

  // Word-at-a-time cursor: `mask` holds the live chunks of the current bit
  // word still to yield (bits of chunks at or past C cleared); __ffs takes
  // the lowest, so chunks come in position order. Super ids, floors and bit
  // words come from the staged head, or past it from global memory; no
  // entry at or past the block's live count is read. (Caching the current
  // super's id and floor in registers made K12 5% slower.)
  struct Cursor {
    const int* s;  // the staged copy
    int n_staged;
    int n_wstaged;
    int n_live;
    int words_per_super;
    int n_words;
    int C;
    int sp;
    int wq;
    int wbase;
    unsigned mask;

    // Block b's global row i of the lists: 0 order, 1 minds, 2 bits.
    template <class T>
    __device__ const T* row(int i) const {
      return static_cast<const T*>(reinterpret_cast<const void* const*>(s)[i]);
    }

    __device__ int super_at(int p) const {
      return p < n_staged ? s[kHead + p] : row<int>(0)[p];
    }

    __device__ bool advance(int* k, float* floor_out) {
      while (mask == 0u) {
        if (++wq == words_per_super) {
          wq = 0;
          ++sp;
        }
        if (sp >= n_live) return false;
        const int w = super_at(sp) * words_per_super + wq;
        wbase = w * 32;
        const int below_c = C - wbase;  // chunks of this word below C
        if (w < n_words && below_c > 0) {
          mask = static_cast<unsigned>(w < n_wstaged ? s[kHead + 2 * n_staged + w]
                                                     : row<int>(2)[w]);
        } else {
          mask = 0u;
        }
        if (below_c < 32) mask &= below_c > 0 ? (1u << below_c) - 1u : 0u;
      }
      *k = wbase + __ffs(mask) - 1;
      mask &= mask - 1u;
      *floor_out = sp < n_staged ? reinterpret_cast<const float*>(s + kHead + n_staged)[sp]
                                 : row<float>(1)[super_at(sp)];
      return true;
    }
  };

  __device__ Cursor cursor(int b, const int* s) const {
    return Cursor{s, n_staged(), n_words_staged(), counts[b], S / 32, n_words, C,
                  0, -1, 0, 0u};
  }
};

// --- the primary walk (K5, K11) -----------------------------------------------

// This warp's rays against chunk k, lane i holding triangle i's row in c:
// each ray's best goes from best_in to best_out; returns the max of the
// rays' bound terms min(t, union-box bound).
template <bool kMaskTail>
__device__ __forceinline__ float test_shared_chunk(const float* c, int k, int T,
                                                   const float4* s_dir, const Best* best_in,
                                                   Best* best_out, int warp, int lane) {
  const bool tri_live = !kMaskTail || lane < T - k * rpt::kTC;
  float wmax = 0.0f;
  for (int a0 = warp; a0 < kSlots; a0 += kWarps * kBatch) {
    float det[kBatch], un[kBatch], vn[kBatch], bound[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const float4 d = s_dir[a0 + r * kWarps];
      rpt::shared_tri_sums(c, d.x, d.y, d.z, &det[r], &un[r], &vn[r]);
      bound[r] = d.w;
    }
    float dist[kBatch], u[kBatch], v[kBatch];
    unsigned key[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const bool ok = rpt::mt_accept(det[r], un[r], vn[r], c[9], &u[r], &v[r], &dist[r]);
      if (!(ok && tri_live)) dist[r] = rpt::kInf;
      key[r] = __float_as_uint(fabsf(dist[r]));
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = a0 + r * kWarps;
      const unsigned kmin = __reduce_min_sync(0xffffffffu, key[r]);
      Best best = best_in[a];
      // The winner's dist is |dist| at the min, or -0.0 where that is 0, so
      // it is below the ray's best exactly when |dist| is (strict <: across
      // chunks the earlier one wins a tie); only then is the winner fetched.
      if (__uint_as_float(kmin) < best.t) {
        // the lowest lane at the chunk's min: jnp.argmin's first minimum
        const int win = __ffs(__ballot_sync(0xffffffffu, key[r] == kmin)) - 1;
        best = Best{__shfl_sync(0xffffffffu, dist[r], win), __shfl_sync(0xffffffffu, u[r], win),
                    __shfl_sync(0xffffffffu, v[r], win), k * rpt::kTC + win};
      }
      if (lane == 0) best_out[a] = best;
      wmax = fmaxf(wmax, fminf(best.t, bound[r]));
    }
  }
  __syncwarp();  // lane 0's best_out before the warp reads it
  return wmax;
}

// The primary walk; see the note at the head of this file. Dynamic shared
// memory: the list's stage_words() words.
template <class List>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
shared_walk_kernel(List list, const float* __restrict__ box, const float* __restrict__ tri,
                   const float* __restrict__ attrs, const float* __restrict__ dh, int n, int T,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ tri_out,
                   float* __restrict__ attr_out) {
  static_assert(kSlots % (kWarps * kBatch) == 0, "every warp tests whole batches of rays");
  __shared__ float4 s_dir[kSlots];     // per ray of this CTA: direction, union-box bound
  __shared__ Best s_best[2][kSlots];   // two halves, see the walk
  __shared__ float s_red[kWarps];
  // every warp value of the cluster, pushed by its warp; two halves
  __shared__ float s_all[2][kCluster * kWarps];
  extern __shared__ int s_list[];      // List::stage
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = static_cast<size_t>(b) * rpt::kNB;
  const size_t first = blk + static_cast<size_t>(rank) * kSlots;  // this CTA's first lane

  // --- the block's first bound, computed alike in every CTA -----------------
  list.stage(b, s_list);
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int e = q * kThreads + tid;  // lane of the block
    const size_t li = blk + e;
    const float dx = dh[li], dy = dh[n + li], dz = dh[2 * static_cast<size_t>(n) + li];
    const float bound = rpt::box_bound(lo, hi, box[6], box[7], box[8], dx, dy, dz);
    if (e / kSlots == rank) {
      s_dir[e % kSlots] = make_float4(dx, dy, dz, bound);
      s_best[0][e % kSlots] = Best{rpt::kInf, 0.0f, 0.0f, -1};
    }
    local = fmaxf(local, bound);
  }
  // its barriers also publish s_dir, s_best[0] and the list
  float mb = rpt::block_max<kThreads>(local, s_red);

  // --- the walk -------------------------------------------------------------
  // Chunk j's bound goes out with a split cluster barrier: while it
  // completes, the warps test candidate j + 1 as if it will be walked, into
  // the other half of s_best, and the half that holds the walked chunks
  // flips only if the bound says the candidate is walked.
  const float2* rows2 = reinterpret_cast<const float2*>(tri);
  typename List::Cursor cursor = list.cursor(b, s_list);
  int cur = 0;  // s_best[cur]: each ray's best over the walked chunks
  int k, kn;
  float fl, fl_next;
  if (cursor.advance(&k, &fl) && fl < mb) {  // the same decision in every CTA
    // This CTA runs: the cluster's pushes may start once every CTA arrived.
    cluster_arrive();
    float c[kShRow], cn[kShRow];
    load_shared_row(rows2, k, lane, c);
    bool more = cursor.advance(&kn, &fl_next);
    if (more) load_shared_row(rows2, kn, lane, cn);
    float wmax = test_shared_chunk<List::kMaskTail>(c, k, T, s_dir, s_best[0], s_best[1], warp,
                                                    lane);
    cur = 1;
    int par = 0;
    cluster_wait();
    while (true) {
      // Two alternating halves of s_all: a half is written again only after
      // the next barrier, which every reader of it has passed.
      push_to_cluster(cluster, s_all[par], rank * kWarps + warp, wmax, lane);
      cluster_arrive();
      int k2 = 0;
      float fl2 = 0.0f, wnext = 0.0f;
      bool more2 = false;
      if (more) {
        k = kn;
#pragma unroll
        for (int e = 0; e < kShRow; ++e) c[e] = cn[e];
        more2 = cursor.advance(&k2, &fl2);
        // the next candidate's row, before any bound decides about it
        if (more2) load_shared_row(rows2, k2, lane, cn);
        wnext = test_shared_chunk<List::kMaskTail>(c, k, T, s_dir, s_best[cur],
                                                   s_best[cur ^ 1], warp, lane);
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
    // Every push into this CTA came before its pusher's last arrive, which
    // the last wait saw: no other CTA touches this one's shared memory now.
  }
  __syncthreads();  // every warp's s_best[cur]

  // --- results: this CTA's lanes, and each hit's attribute row --------------
  const int s = tid % kSlots;
  const Best best = s_best[cur][s];
  if (tid < kSlots) {
    t_out[first + s] = best.t;
    u_out[first + s] = best.u;
    v_out[first + s] = best.v;
    tri_out[first + s] = best.tri;
  }
  const float* row = attrs + static_cast<size_t>(best.tri < 0 ? 0 : best.tri) * kAttr;
  for (int a = tid / kSlots; a < kAttr; a += kThreads / kSlots) {
    attr_out[static_cast<size_t>(a) * n + first + s] = best.tri < 0 ? 0.0f : row[a];
  }
}

// --- the shadow walk (K6, K12) ------------------------------------------------

// This warp's rays against chunk k, lane i holding triangle i's row in c:
// each ray's running min goes from bt_in to bt_out; returns the max of the
// rays' bound terms.
template <bool kMaskTail>
__device__ __forceinline__ float test_chunk(const float* c, int k, int T,
                                            const float4* s_ray, const float* bt_in,
                                            float* bt_out, int n_mine, int warp, int lane) {
  const bool tri_live = !kMaskTail || lane < T - k * rpt::kTC;
  float wmax = 0.0f;
  // kBatch rays at a time, general_tri_test split in two: the rays' sums
  // (most of the work, no branches) interleave; the divisions, whose
  // IEEE slow path is a branch, follow one ray after another.
  for (int a0 = warp; a0 < n_mine; a0 += kWarps * kBatch) {
    float det[kBatch], un[kBatch], vn[kBatch], tn[kBatch];
    float tcut[kBatch], teff[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = min(a0 + r * kWarps, n_mine - 1);  // past the end: a copy
      const float4 p0 = s_ray[3 * a], p1 = s_ray[3 * a + 1], p2 = s_ray[3 * a + 2];
      const float x[10] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y};
      rpt::general_tri_sums(c, x, &det[r], &un[r], &vn[r], &tn[r]);
      tcut[r] = p2.z;
      teff[r] = p2.w;
    }
    unsigned key[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      float u, v, dist;
      const bool ok = rpt::mt_accept(det[r], un[r], vn[r], tn[r], &u, &v, &dist) && tri_live;
      key[r] = __float_as_uint(ok ? fabsf(dist) : rpt::kInf);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) key[r] = __reduce_min_sync(0xffffffffu, key[r]);
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = a0 + r * kWarps;
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
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
general_walk_kernel(List list, const float* __restrict__ box, const float* __restrict__ rows,
                    const float* __restrict__ r10, const float* __restrict__ tmax2, int n,
                    int T, float* __restrict__ t_out) {
  static_assert(kCluster * kWarps % 32 == 0, "cluster_max reads whole warps of values");
  // per slot [d(3) m0] [m1 m2 o0 o1] [o2 x9 tcut teff], and its running min bt
  __shared__ float4 s_ray[3 * kSlots];
  __shared__ float s_bt[2][kSlots];  // two halves, see the walk
  __shared__ int s_count[kWarps];
  __shared__ float s_first[kWarps];  // warp values of the first bound
  // every warp value of the cluster, pushed by its warp; two halves
  __shared__ float s_all[2][kCluster * kWarps];
  extern __shared__ int s_list[];         // List::stage
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = static_cast<size_t>(b) * rpt::kNB;

  // --- compaction: slots for the lanes with tmax > 0 ------------------------
  // Every CTA of the cluster numbers the block's active lanes the same way
  // and keeps those whose slot s has s % kCluster == rank, at s / kCluster.
  unsigned act = 0u;  // bit q: lane q * kThreads + tid is active
  float tm[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    tm[q] = tmax2[blk + q * kThreads + tid];
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
  for (int w = 0; w < kWarps; ++w) {
    slot += w < warp ? s_count[w] : 0;
    n_act += s_count[w];
  }
  const int first_slot = slot;
  if (n_act == 0) {  // nothing to test: every lane's result is its tmax
    if (rank == 0) {
#pragma unroll
      for (int q = 0; q < kLanes; ++q) t_out[blk + q * kThreads + tid] = tm[q];
    }
    return;  // the whole cluster returns here, before any cluster barrier
  }

  list.stage(b, s_list);
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    if (!((act >> q) & 1u)) continue;
    if (slot % kCluster == rank) {
      const size_t li = blk + q * kThreads + tid;
      const int s = slot / kCluster;
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
  const int n_mine = (n_act - rank + kCluster - 1) / kCluster;
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
      // Two alternating halves of s_all: a half is written again only after
      // the next barrier, which every reader of it has passed.
      push_to_cluster(cluster, s_all[par], rank * kWarps + warp, wmax, lane);
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
  for (int q = 0; q < kLanes; ++q) {
    const size_t li = blk + q * kThreads + tid;
    if ((act >> q) & 1u) {
      if (slot % kCluster == rank) t_out[li] = fminf(s_bt[cur][slot / kCluster], tm[q]);
      ++slot;
    } else if (rank == 0) {
      t_out[li] = tm[q];
    }
  }
}

// Launch shared_walk_kernel<List>, one cluster per 1024-ray block, with the
// shared memory its list needs.
template <class List>
int launch_shared_walk(const List& list, const void* box, const void* tri, const void* attrs,
                       const void* dh, int n, int T, void* t, void* u, void* v, void* tri_out,
                       void* attr, void* stream) {
  static SharedOptIn opt;
  int max_bytes = 0;
  const cudaError_t err = opt_in_shared(shared_walk_kernel<List>, opt, &max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = 4 * list.stage_words();
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri) % sizeof(float2) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  shared_walk_kernel<<<n / rpt::kNB * kCluster, kThreads, bytes, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(tri),
      static_cast<const float*>(attrs), static_cast<const float*>(dh), n, T,
      static_cast<float*>(t), static_cast<float*>(u), static_cast<float*>(v),
      static_cast<int*>(tri_out), static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

// Launch general_walk_kernel<List>, one cluster per 1024-ray block, with the
// shared memory its list needs.
template <class List>
int launch_general_walk(const List& list, const void* box, const void* rows, const void* r10,
                        const void* tmax2, int n, int T, void* t, void* stream) {
  static SharedOptIn opt;
  int max_bytes = 0;
  const cudaError_t err = opt_in_shared(general_walk_kernel<List>, opt, &max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = 4 * list.stage_words();
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  general_walk_kernel<<<n / rpt::kNB * kCluster, kThreads, bytes, as_stream(stream)>>>(
      list, static_cast<const float*>(box), static_cast<const float*>(rows),
      static_cast<const float*>(r10), static_cast<const float*>(tmax2), n, T,
      static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rpt_shared_walk(const void* order, const void* minds, const void* counts,
                               const void* box, const void* tri, const void* attrs,
                               const void* dh, int n, int n_chunks, void* t, void* u,
                               void* v, void* tri_out, void* attr, void* stream) {
  const FlatList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                      static_cast<const int*>(counts), n_chunks};
  return launch_shared_walk(list, box, tri, attrs, dh, n, n_chunks * rpt::kTC, t, u, v, tri_out,
                            attr, stream);
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
  if (S <= 0 || S % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);  // whole bit words
  const SuperList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                       static_cast<const int*>(counts), static_cast<const int*>(bits),
                       n_super, n_words, S, C};
  return launch_shared_walk(list, box, tri, attrs, dh, n, T, t, u, v, tri_out, attr, stream);
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
