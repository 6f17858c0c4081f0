// K9 and K10: the mesh walks over every mesh object at once.
//
// Replaces relativitypathtracer_tpu/ops/pallas/mesh_batch.py:
//   _shared_batch_kernel  (K9, wrapper batched_nearest_shared): nearest
//                         triangle hit of primary rays over the fused chunk
//                         pool of all mesh objects;
//   _general_batch_kernel (K10, wrapper batched_min_t_general): its shadow
//                         twin, min hit over the pool bounded by tmax, with
//                         occlusion retirement on new_t < tmax.
//
// Every chunk of the pool belongs to one object (chunk -> object table
// cobj) and is tested in that object's rest frame. Distances from different
// frames are made comparable by a per-lane scale s (object distance ->
// shared 4D ray parameter, t = dist * |M_R dh| / |d3|), so the nearest-hit
// reduce, the walk bound and early termination all run in shared units; the
// live lists' floors are in shared units too (mesh_batch.
// live_chunk_lists_multi).
//
// What bounds them on this card: arithmetic and the walk's length, as for
// K5/K6 (csrc/mesh_kernels.cu): 32 ray/triangle tests per walked chunk and
// ray, plus one multiply by s. Rays, lists and outputs are read and written
// once. A block's list is copied into shared memory up to FlatList::
// kStageMax entries (csrc/walk.cuh), which holds the instances path's whole
// pool; a walk past them reads its list from global memory, so a pool of any
// size runs.
//
// Design: the cluster walks of K5 and K6 (csrc/mesh_kernels.cu, whose note
// describes them; the pieces they share are in csrc/walk.cuh). Each
// 1024-ray block is spread over a cluster of 8 CTAs on 8 SMs; warp w of a
// CTA takes its rays w, w + 8, ...; lane i holds triangle i of the chunk
// (its row in registers) and tests it against the ray, whose values every
// lane reads from one shared address; the chunk's min (K10) or argmin (K9)
// is one warp reduction; each warp pushes its rays' bound term into every
// CTA of the cluster, one split cluster barrier per chunk, and the next
// chunk is tested speculatively while the barrier completes, into the other
// half of a double-buffered running best that is dropped when the walk
// stops.
//
// The per-object rays. A ray's object-frame values differ per object: for
// K9 dh and s (a float4), for K10 x = [dh, ro x dh, ro, 1] and s (12 floats
// with a pad). As the TPU fills them into VMEM scratch at block start
// (_fill_ray_scratch), each CTA derives them at entry for its own rays (at
// most 128, kSlots) and every object into shared memory, and a walk reads
// the row of the chunk's object. The lists are sorted by distance, not by
// object, so a walk changes object often (chip_smoke.py prints how often);
// a row read costs nothing more than the ray read K5/K6 make. Shared memory
// holds the rays of at most kTileSh (K9: 16 x 128 x 16 B = 32 KB) or
// kTileGen (K10: 8 x 128 x 48 B = 48 KB) objects, which keeps 3 CTAs on an
// SM; a scene with more objects stages them in tiles of that many objects:
// on a chunk whose object lies outside the staged tile the CTA derives that
// tile's rays again (two CTA barriers, uniform across the CTA since every
// thread runs the same cursor), so any O runs. The derivation (object_dir,
// object_ray) runs the JAX package's operations in its order (mat_rows left
// to right, then IEEE sqrt and division), the same function at entry and on
// a refill, so a staged ray is the one the plain twin computes, to the bit.
//
// K9, the primary walk (K5's mapping). CTA r owns the block's lanes r * 128
// ... r * 128 + 127. The chunk argmin runs on tsh = dist * s (INF where the
// test rejects, as the twin's torch.where): __reduce_min_sync on the bits of
// fabsf(tsh) (accepted distances are >= 0 or -0.0, so non-negative floats
// order as their bits), __ballot_sync and __ffs take the lowest lane at the
// min, the first minimum as jnp.argmin and the twin's tsh.argmin take it;
// the winner's tsh, u and v come from its lane by __shfl_sync (a -0.0 stays
// -0.0), and only where the chunk's min is below the ray's best (strict <:
// across chunks the earlier one wins a tie). The winner's object slot is
// its chunk's (cobj), read at the end with its 15 attributes as one fp32
// row (the TPU selects them with hi/lo bf16 one-hot products). The block's
// first bound (per lane the max over objects of the union-box exit times
// s) is each CTA's max over its own 128 lanes, then one cluster reduction:
// an eighth of the object_dir derivations that K5's way (every CTA over all
// 1,024 lanes, no cluster barrier) takes, for one cluster barrier more; on
// the instances path it ran K9 in 0.752 ms against 0.921 ms (PERF.md).
//
// K10, the shadow walk (K6's mapping). Most lanes cast no shadow ray
// (tmax = 0); such a lane needs no test: its result min(bt, tmax) is tmax
// and its bound term is at most 0. At entry every CTA numbers the block's
// lanes with tmax > 0 the same way (a warp scan and a prefix over the
// warps) and keeps every eighth; a block with none writes min(INF, tmax) and
// returns before any cluster barrier. A lane whose running min falls below
// its tmax is occluded and pushes 0 into the bound. The masked lanes' rays
// are never read, so garbage there changes no bit of the output.
//
// Exactness: each kernel equals its plain twin (mesh_batch.
// batched_shared_walk_plain, batched_general_walk_plain, which test every
// lane) bit for bit: the same fp32 operations in the same order under
// -fmad=false, the same argmin, and the same chunks walked, since every
// decision reads the twin's block bound (a max is exact in any order). No
// tensor cores: a test's 9 (K9) or 19 (K10) products are exact fp32 sums,
// left to right, and TF32 (or 3xTF32 emulation) would give other bits; the
// JAX package's reduced-precision products broke oracle parity. The walks
// use the SM's fp32 units, shared and distributed shared memory, warp
// reductions, cluster barriers and register-staged loads. The TPU's chunk
// pairing (a fix for TPU loop overhead) is not copied.
#include <cstdint>

#include "walk.cuh"

namespace {

// The per-object transform table (mesh_batch.MAT_COLS columns).
constexpr int kMatCols = 40;
constexpr int kA = 0;    // 12: fused dir/origin transform inv_m[:3,:3] @ L[1:4,:]
constexpr int kB = 12;   // 3: inv_m translation
constexpr int kMR = 18;  // 9: m[:3,:3] (object -> rest scale for s)
constexpr int kL3 = 27;  // 12: L[1:4,:] (|d3| for s)

// Objects whose rays a CTA stages at once (a tile); see the note above.
constexpr int kTileSh = 16;
constexpr int kTileGen = 8;

// out[i] = sum_j m[base + ncols * i + j] * vec[j], left to right.
template <int NCOLS>
__device__ __forceinline__ void mat_rows(const float* m, int base, const float* vec,
                                         float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = m[base + NCOLS * i] * vec[0];
#pragma unroll
    for (int j = 1; j < NCOLS; ++j) acc = acc + m[base + NCOLS * i + j] * vec[j];
    out[i] = acc;
  }
}

__device__ __forceinline__ float len3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// Unit object-space direction dh and scale s of the camera-frame 4-dir d4
// in the object of table row m (mesh_batch._fill_ray_scratch).
__device__ __forceinline__ void object_dir(const float* m, const float* d4, float* dh,
                                           float* s) {
  float d[3], d3[3], mdh[3];
  mat_rows<4>(m, kA, d4, d);
  const float dn = len3(d);
  dh[0] = d[0] / dn;
  dh[1] = d[1] / dn;
  dh[2] = d[2] / dn;
  mat_rows<4>(m, kL3, d4, d3);
  mat_rows<3>(m, kMR, dh, mdh);
  *s = len3(mdh) / len3(d3);
}

// The general ray x = [dh, ro x dh, ro, 1] and s of the camera-frame
// 4-origin o4 and 4-dir d4 in the object of table row m.
__device__ __forceinline__ void object_ray(const float* m, const float* o4, const float* d4,
                                           float* x, float* s) {
  object_dir(m, d4, x, s);
  float ro[3];
  mat_rows<4>(m, kA, o4, ro);
  ro[0] = ro[0] + m[kB];
  ro[1] = ro[1] + m[kB + 1];
  ro[2] = ro[2] + m[kB + 2];
  x[3] = ro[1] * x[2] - ro[2] * x[1];
  x[4] = ro[2] * x[0] - ro[0] * x[2];
  x[5] = ro[0] * x[1] - ro[1] * x[0];
  x[6] = ro[0];
  x[7] = ro[1];
  x[8] = ro[2];
  x[9] = 1.0f;
}

__device__ __forceinline__ float4 as_float4(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Max over the CTA's warps of their lanes' values, pushed as every warp's
// value into the cluster-wide table `first`, then read back as the
// cluster's max (the walks' first bound when each CTA computes it over its
// own rays): cluster.sync() in between, which also publishes every earlier
// shared store of the CTA.
__device__ __forceinline__ float cluster_first_bound(cooperative_groups::cluster_group& cluster,
                                                     float* first, float local, int warp,
                                                     int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  }
  if (lane == 0) first[warp] = local;
  // every CTA of the cluster runs, and its values and rays are in place,
  // before any reads another's shared memory
  cluster.sync();
  return cluster_max(cluster, first, lane);
}

// --- K9, the primary walk ------------------------------------------------------

// This CTA's per-object dirs of tile t (objects t * tile ... t * tile +
// tile - 1, those below n_obj) from the camera-frame dirs s_d4, into s_dir
// (tile x kSlots float4: dh, s). The barriers keep the tile it replaces
// until every warp is done with it.
__device__ void stage_dirs(int t, int tile, int n_obj, const float* mats, const float4* s_d4,
                           float4* s_dir) {
  __syncthreads();
  for (int e = threadIdx.x; e < tile * kSlots; e += kThreads) {
    const int g = t * tile + e / kSlots;
    if (g >= n_obj) break;
    const float4 q = s_d4[e % kSlots];
    const float d4[4] = {q.x, q.y, q.z, q.w};
    float dh[3], s;
    object_dir(mats + static_cast<size_t>(g) * kMatCols, d4, dh, &s);
    s_dir[e] = make_float4(dh[0], dh[1], dh[2], s);
  }
  __syncthreads();
}

// This warp's rays against chunk k, lane i holding triangle i's row in c;
// s_dir: the rays' (dh, s) in the chunk's object. Each ray's best goes from
// best_in to best_out; returns the max of the rays' bound terms min(t,
// first bound).
__device__ __forceinline__ float test_batched_shared_chunk(const float* c, int k,
                                                           const float4* s_dir,
                                                           const float* s_bound,
                                                           const Best* best_in, Best* best_out,
                                                           int warp, int lane) {
  float wmax = 0.0f;
  for (int a0 = warp; a0 < kSlots; a0 += kWarps * kBatch) {
    float det[kBatch], un[kBatch], vn[kBatch], s[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const float4 d = s_dir[a0 + r * kWarps];
      rpt::shared_tri_sums(c, d.x, d.y, d.z, &det[r], &un[r], &vn[r]);
      s[r] = d.w;
    }
    float tsh[kBatch], u[kBatch], v[kBatch];
    unsigned key[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      float dist;
      const bool ok = rpt::mt_accept(det[r], un[r], vn[r], c[9], &u[r], &v[r], &dist);
      // the twin's torch.where(dist < INF, dist * s, INF)
      tsh[r] = ok && dist < rpt::kInf ? dist * s[r] : rpt::kInf;
      key[r] = __float_as_uint(fabsf(tsh[r]));
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = a0 + r * kWarps;
      const unsigned kmin = __reduce_min_sync(0xffffffffu, key[r]);
      Best best = best_in[a];
      if (__uint_as_float(kmin) < best.t) {
        // the lowest lane at the chunk's min: jnp.argmin's first minimum
        const int win = __ffs(__ballot_sync(0xffffffffu, key[r] == kmin)) - 1;
        best = Best{__shfl_sync(0xffffffffu, tsh[r], win), __shfl_sync(0xffffffffu, u[r], win),
                    __shfl_sync(0xffffffffu, v[r], win), k * rpt::kTC + win};
      }
      if (lane == 0) best_out[a] = best;
      wmax = fmaxf(wmax, fminf(best.t, s_bound[a]));
    }
  }
  __syncwarp();  // lane 0's best_out before the warp reads it
  return wmax;
}

// The primary walk; see the note at the head of this file. Dynamic shared
// memory: tile x kSlots float4 of per-object dirs, then the list's
// stage_words() words. Four CTAs an SM (64 registers, a few bytes spilled)
// ran it 9% faster on the instances path than three at 72 registers
// (chip_smoke.py); a launch bound of three CTAs made K10 slower (80
// registers, 174 bytes spilled), so K10 keeps the compiler's choice.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
batched_shared_walk_kernel(FlatList list, const int* __restrict__ cobj,
                           const float* __restrict__ boxes, const float* __restrict__ mats,
                           const float* __restrict__ tri, const float* __restrict__ attrs,
                           const float* __restrict__ dir4, int n, int n_obj, int tile,
                           float* __restrict__ t_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, int* __restrict__ tri_out,
                           int* __restrict__ obj_out, float* __restrict__ attr_out) {
  static_assert(kSlots % (kWarps * kBatch) == 0, "every warp tests whole batches of rays");
  __shared__ float4 s_d4[kSlots];     // per ray of this CTA: its camera-frame 4-dir
  __shared__ float s_bound[kSlots];   // and its first bound
  __shared__ Best s_best[2][kSlots];  // two halves, see the walk
  __shared__ float s_first[kWarps];   // warp values of the first bound
  // every warp value of the cluster, pushed by its warp; two halves
  __shared__ float s_all[2][kCluster * kWarps];
  extern __shared__ float4 s_dir[];   // per-object dirs of the staged tile, then the list
  int* s_list = reinterpret_cast<int*>(s_dir + tile * kSlots);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = static_cast<size_t>(b) * rpt::kNB;
  const size_t first = blk + static_cast<size_t>(rank) * kSlots;  // this CTA's first lane

  // --- per-object dirs of tile 0, and the first bound ------------------------
  list.stage(b, s_list);
  float local = 0.0f;
  if (tid < kSlots) {
    const size_t li = first + tid;
    const float d4[4] = {dir4[li], dir4[n + li], dir4[2 * static_cast<size_t>(n) + li],
                         dir4[3 * static_cast<size_t>(n) + li]};
    // per lane the max over objects of the union-box exit in shared units
    float bound = 0.0f;
    for (int g = 0; g < n_obj; ++g) {
      float dh[3], s;
      object_dir(mats + static_cast<size_t>(g) * kMatCols, d4, dh, &s);
      const float* bx = boxes + static_cast<size_t>(g) * 9;
      bound = fmaxf(bound,
                    rpt::box_bound(bx, bx + 3, bx[6], bx[7], bx[8], dh[0], dh[1], dh[2]) * s);
      if (g < tile) s_dir[g * kSlots + tid] = make_float4(dh[0], dh[1], dh[2], s);
    }
    s_d4[tid] = as_float4(d4);
    s_bound[tid] = bound;
    s_best[0][tid] = Best{rpt::kInf, 0.0f, 0.0f, -1};
    local = bound;
  }
  // publishes the staged rays, the bounds, s_best[0] and the list
  float mb = cluster_first_bound(cluster, s_first, local, warp, lane);

  // --- the walk -------------------------------------------------------------
  // Chunk j's bound goes out with a split cluster barrier: while it
  // completes, the warps test candidate j + 1 as if it will be walked, into
  // the other half of s_best, and the half that holds the walked chunks
  // flips only if the bound says the candidate is walked.
  const float2* rows2 = reinterpret_cast<const float2*>(tri);
  FlatList::Cursor cursor = list.cursor(b, s_list);
  int cur = 0;        // s_best[cur]: each ray's best over the walked chunks
  int staged = 0;     // the tile whose dirs s_dir holds
  int k, kn;
  float fl, fl_next;
  if (cursor.advance(&k, &fl) && fl < mb) {  // the same decision in every CTA
    float c[kShRow], cn[kShRow];
    load_shared_row(rows2, k, lane, c);
    bool more = cursor.advance(&kn, &fl_next);
    if (more) load_shared_row(rows2, kn, lane, cn);
    int g = cobj[k];
    if (g / tile != staged) {
      staged = g / tile;
      stage_dirs(staged, tile, n_obj, mats, s_d4, s_dir);
    }
    float wmax = test_batched_shared_chunk(c, k, s_dir + (g % tile) * kSlots, s_bound,
                                           s_best[0], s_best[1], warp, lane);
    cur = 1;
    int par = 0;
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
        g = cobj[k];
        if (g / tile != staged) {
          staged = g / tile;
          stage_dirs(staged, tile, n_obj, mats, s_d4, s_dir);
        }
        wnext = test_batched_shared_chunk(c, k, s_dir + (g % tile) * kSlots, s_bound,
                                          s_best[cur], s_best[cur ^ 1], warp, lane);
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
  cluster.sync();  // s_first stays until the cluster has read it

  // --- results: this CTA's lanes, each hit's object and attribute row -------
  const int s = tid % kSlots;
  const Best best = s_best[cur][s];
  if (tid < kSlots) {
    t_out[first + s] = best.t;
    u_out[first + s] = best.u;
    v_out[first + s] = best.v;
    tri_out[first + s] = best.tri;
    obj_out[first + s] = best.tri < 0 ? -1 : cobj[best.tri / rpt::kTC];
  }
  const float* row = attrs + static_cast<size_t>(best.tri < 0 ? 0 : best.tri) * kAttr;
  for (int a = tid / kSlots; a < kAttr; a += kThreads / kSlots) {
    attr_out[static_cast<size_t>(a) * n + first + s] = best.tri < 0 ? 0.0f : row[a];
  }
}

// --- K10, the shadow walk ------------------------------------------------------

// Slot a of object tile slot gl in s_ray: [d(3) m0] [m1 m2 o0 o1] [o2 1 s 0].
__device__ __forceinline__ void put_ray(float4* s_ray, int gl, int a, const float* x, float s) {
  float4* p = s_ray + 3 * (gl * kSlots + a);
  p[0] = make_float4(x[0], x[1], x[2], x[3]);
  p[1] = make_float4(x[4], x[5], x[6], x[7]);
  p[2] = make_float4(x[8], x[9], s, 0.0f);
}

// This CTA's per-object rays of tile t for its n_mine slots from their
// camera-frame origins and dirs, into s_ray; barriers as stage_dirs.
__device__ void stage_rays(int t, int tile, int n_obj, int n_mine, const float* mats,
                           const float4* s_o4, const float4* s_d4, float4* s_ray) {
  __syncthreads();
  for (int e = threadIdx.x; e < tile * kSlots; e += kThreads) {
    const int g = t * tile + e / kSlots, a = e % kSlots;
    if (g >= n_obj) break;
    if (a >= n_mine) continue;
    const float4 p = s_o4[a], q = s_d4[a];
    const float o4[4] = {p.x, p.y, p.z, p.w}, d4[4] = {q.x, q.y, q.z, q.w};
    float x[10], s;
    object_ray(mats + static_cast<size_t>(g) * kMatCols, o4, d4, x, &s);
    put_ray(s_ray, e / kSlots, a, x, s);
  }
  __syncthreads();
}

// This warp's rays against chunk k, lane i holding triangle i's row in c;
// s_ray: the rays in the chunk's object. Each ray's running min goes from
// bt_in to bt_out; returns the max of the rays' bound terms.
__device__ __forceinline__ float test_batched_general_chunk(const float* c, const float4* s_ray,
                                                            const float* s_tmax,
                                                            const float* s_teff,
                                                            const float* bt_in, float* bt_out,
                                                            int n_mine, int warp, int lane) {
  float wmax = 0.0f;
  // kBatch rays at a time: the rays' sums (most of the work, no branches)
  // interleave; the divisions, whose IEEE slow path is a branch, follow.
  for (int a0 = warp; a0 < n_mine; a0 += kWarps * kBatch) {
    float det[kBatch], un[kBatch], vn[kBatch], tn[kBatch], s[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = min(a0 + r * kWarps, n_mine - 1);  // past the end: a copy
      const float4 p0 = s_ray[3 * a], p1 = s_ray[3 * a + 1], p2 = s_ray[3 * a + 2];
      const float x[10] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y};
      rpt::general_tri_sums(c, x, &det[r], &un[r], &vn[r], &tn[r]);
      s[r] = p2.z;
    }
    unsigned key[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      float u, v, dist;
      const bool ok = rpt::mt_accept(det[r], un[r], vn[r], tn[r], &u, &v, &dist);
      // the twin's torch.where(dist < INF, dist * s, INF)
      key[r] = __float_as_uint(ok && dist < rpt::kInf ? fabsf(dist * s[r]) : rpt::kInf);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) key[r] = __reduce_min_sync(0xffffffffu, key[r]);
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int a = a0 + r * kWarps;
      if (a >= n_mine) break;
      const float bt = fminf(bt_in[a], __uint_as_float(key[r]));
      if (lane == 0) bt_out[a] = bt;
      // Occlusion retirement: any hit below tmax (both in shared units)
      // proves the lane shadowed, and it stops extending the block's bound.
      wmax = fmaxf(wmax, bt < s_tmax[a] ? 0.0f : fminf(bt, s_teff[a]));
    }
  }
  __syncwarp();  // lane 0's bt_out before the warp reads it
  return wmax;
}

// The shadow walk; see the note at the head of this file. Dynamic shared
// memory: tile x kSlots x 3 float4 of per-object rays, then the list's
// stage_words() words.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
batched_general_walk_kernel(FlatList list, const int* __restrict__ cobj,
                            const float* __restrict__ boxes, const float* __restrict__ mats,
                            const float* __restrict__ rows, const float* __restrict__ origins4,
                            const float* __restrict__ dir4, const float* __restrict__ tmax_in,
                            int n, int n_obj, int tile, float* __restrict__ t_out) {
  static_assert(kCluster * kWarps % 32 == 0, "cluster_max reads whole warps of values");
  __shared__ float4 s_o4[kSlots], s_d4[kSlots];  // per slot: camera-frame 4-origin, 4-dir
  __shared__ float s_tmax[kSlots], s_teff[kSlots];
  __shared__ float s_bt[2][kSlots];  // two halves, see the walk
  __shared__ int s_count[kWarps];
  __shared__ float s_first[kWarps];  // warp values of the first bound
  // every warp value of the cluster, pushed by its warp; two halves
  __shared__ float s_all[2][kCluster * kWarps];
  extern __shared__ float4 s_ray[];  // per-object rays of the staged tile, then the list
  int* s_list = reinterpret_cast<int*>(s_ray + 3 * tile * kSlots);
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
    tm[q] = tmax_in[blk + q * kThreads + tid];
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
  if (n_act == 0) {  // nothing to test: every lane's result is min(INF, tmax)
    if (rank == 0) {
#pragma unroll
      for (int q = 0; q < kLanes; ++q) t_out[blk + q * kThreads + tid] = fminf(rpt::kInf, tm[q]);
    }
    return;  // the whole cluster returns here, before any cluster barrier
  }

  // --- per-object rays of tile 0, and each slot's walk bound ---------------
  list.stage(b, s_list);
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    if (!((act >> q) & 1u)) continue;
    if (slot % kCluster == rank) {
      const size_t li = blk + q * kThreads + tid;
      const int a = slot / kCluster;
      float o4[4], d4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o4[c] = origins4[static_cast<size_t>(c) * n + li];
        d4[c] = dir4[static_cast<size_t>(c) * n + li];
      }
      // Walk bound min(tmax, farthest box exit in shared units). A disabled
      // object (the light) carries the table's stand-in box [1 1 1 0 0 0].
      float bound = 0.0f;
      for (int g = 0; g < n_obj; ++g) {
        float x[10], s;
        object_ray(mats + static_cast<size_t>(g) * kMatCols, o4, d4, x, &s);
        const float* bx = boxes + static_cast<size_t>(g) * 6;
        bound = fmaxf(bound, rpt::box_bound(bx, bx + 3, x[6], x[7], x[8], x[0], x[1], x[2]) * s);
        if (g < tile) put_ray(s_ray, g, a, x, s);
      }
      const float teff = fminf(tm[q], bound);
      s_o4[a] = as_float4(o4);
      s_d4[a] = as_float4(d4);
      s_tmax[a] = tm[q];
      s_teff[a] = teff;
      s_bt[0][a] = rpt::kInf;
      local = fmaxf(local, teff);
    }
    ++slot;
  }
  const int n_mine = (n_act - rank + kCluster - 1) / kCluster;
  float mb = cluster_first_bound(cluster, s_first, local, warp, lane);

  // --- the walk -------------------------------------------------------------
  // As the primary walk: one split cluster barrier per chunk, the next
  // chunk tested speculatively into the other half of s_bt.
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  FlatList::Cursor cursor = list.cursor(b, s_list);
  const bool has_rays = warp < n_mine;
  int cur = 0;     // s_bt[cur]: each ray's min over the walked chunks
  int staged = 0;  // the tile whose rays s_ray holds
  int k, kn;
  float fl, fl_next;
  if (cursor.advance(&k, &fl) && fl < mb) {  // the same decision in every CTA
    float c[kGenRow], cn[kGenRow];
    if (has_rays) load_row(rows4, k, lane, c);
    bool more = cursor.advance(&kn, &fl_next);
    if (has_rays && more) load_row(rows4, kn, lane, cn);
    int g = cobj[k];
    if (g / tile != staged) {
      staged = g / tile;
      stage_rays(staged, tile, n_obj, n_mine, mats, s_o4, s_d4, s_ray);
    }
    float wmax = has_rays ? test_batched_general_chunk(c, s_ray + 3 * (g % tile) * kSlots, s_tmax,
                                                       s_teff, s_bt[0], s_bt[1], n_mine, warp,
                                                       lane)
                          : 0.0f;
    cur = 1;
    int par = 0;
    while (true) {
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
        g = cobj[k];
        if (g / tile != staged) {
          staged = g / tile;
          stage_rays(staged, tile, n_obj, n_mine, mats, s_o4, s_d4, s_ray);
        }
        if (has_rays) {
          wnext = test_batched_general_chunk(c, s_ray + 3 * (g % tile) * kSlots, s_tmax, s_teff,
                                             s_bt[cur], s_bt[cur ^ 1], n_mine, warp, lane);
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

  // --- results: min(bt, tmax) on active lanes, min(INF, tmax) on the others -
  slot = first_slot;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const size_t li = blk + q * kThreads + tid;
    if ((act >> q) & 1u) {
      if (slot % kCluster == rank) t_out[li] = fminf(s_bt[cur][slot / kCluster], tm[q]);
      ++slot;
    } else if (rank == 0) {
      t_out[li] = fminf(rpt::kInf, tm[q]);
    }
  }
}

}  // namespace

extern "C" int rpt_batched_shared_walk(const void* order, const void* minds, const void* counts,
                                       const void* cobj, const void* boxes, const void* mats,
                                       const void* tri, const void* attrs, const void* dir4,
                                       int n, int n_chunks, int n_obj, void* t, void* u, void* v,
                                       void* tri_out, void* obj_out, void* attr, void* stream) {
  if (n_obj < 1) return static_cast<int>(cudaErrorInvalidValue);
  static SharedOptIn opt;
  int max_bytes = 0;
  const cudaError_t err = opt_in_shared(batched_shared_walk_kernel, opt, &max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FlatList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                      static_cast<const int*>(counts), n_chunks};
  const int tile = n_obj < kTileSh ? n_obj : kTileSh;
  const size_t bytes = sizeof(float4) * tile * kSlots + 4 * list.stage_words();
  if (reinterpret_cast<uintptr_t>(tri) % sizeof(float2) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  batched_shared_walk_kernel<<<n / rpt::kNB * kCluster, kThreads, bytes, as_stream(stream)>>>(
      list, static_cast<const int*>(cobj), static_cast<const float*>(boxes),
      static_cast<const float*>(mats), static_cast<const float*>(tri),
      static_cast<const float*>(attrs), static_cast<const float*>(dir4), n, n_obj, tile,
      static_cast<float*>(t), static_cast<float*>(u), static_cast<float*>(v),
      static_cast<int*>(tri_out), static_cast<int*>(obj_out), static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_batched_general_walk(const void* order, const void* minds,
                                        const void* counts, const void* cobj,
                                        const void* boxes, const void* mats, const void* rows,
                                        const void* origins4, const void* dir4,
                                        const void* tmax, int n, int n_chunks, int n_obj,
                                        void* t, void* stream) {
  if (n_obj < 1) return static_cast<int>(cudaErrorInvalidValue);
  static SharedOptIn opt;
  int max_bytes = 0;
  const cudaError_t err = opt_in_shared(batched_general_walk_kernel, opt, &max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FlatList list{static_cast<const int*>(order), static_cast<const float*>(minds),
                      static_cast<const int*>(counts), n_chunks};
  const int tile = n_obj < kTileGen ? n_obj : kTileGen;
  const size_t bytes = sizeof(float4) * 3 * tile * kSlots + 4 * list.stage_words();
  if (reinterpret_cast<uintptr_t>(rows) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  batched_general_walk_kernel<<<n / rpt::kNB * kCluster, kThreads, bytes, as_stream(stream)>>>(
      list, static_cast<const int*>(cobj), static_cast<const float*>(boxes),
      static_cast<const float*>(mats), static_cast<const float*>(rows),
      static_cast<const float*>(origins4), static_cast<const float*>(dir4),
      static_cast<const float*>(tmax), n, n_obj, tile, static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}
