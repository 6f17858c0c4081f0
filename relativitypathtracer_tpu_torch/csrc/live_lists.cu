// K4: the live-chunk list build, in three kernels.
//
// Replaces the XLA half of the TPU's hot path in
// relativitypathtracer_tpu/ops/pallas/mesh_kernels.py: live_chunk_lists
// (:389) with its cones _cones_of (:94) and _mask_invalid_lanes (:134), its
// cull _sub_cone_cull (:414) / _cone_cull (:145) and its 16-bucket counting
// sort bucket_order (:174); the two-level live_chunk_lists2 (:277) and
// live_chunk_lists3 (:332) with pack_bits (:218); and mesh_batch.py:118
// live_chunk_lists_multi and mesh_large.py:120 large_live_lists, which are
// built from them. The TPU runs them as dense XLA passes over (sub-cone,
// chunk) arrays; the port's plain twins (mesh_kernels.cone_table_plain,
// live_cull_plain, bucket_order_plain) do the same with torch ops, which on
// the large path made (6,144 x 10,240) temporaries of up to 755 MB in a
// dozen passes, and for the cone table alone some 20 passes over (O, 3,
// n_pad) temporaries of up to 37.7 MB.
//
//   rpt_cone_table (cone_table_kernel): the cone rows [apex(3) axis(3)
//     cos_a sin_a o_rad bound has_valid enabled] of every 128-lane group (a
//     warp each, 8 a CTA) or 1024-lane group (the CTA's 8 warps), a CTA per
//     (1024-lane block, object). A thread holds 4 consecutive lanes, read
//     where they lie (any strides: a stride-0 origin, rows of a larger
//     array; 16-byte loads where the lanes are consecutive), so no list
//     build copies its rays. Masked lanes take their group's mean of the
//     valid ones; the means are pairwise trees, exactly the twin's
//     `_tree_sum`: a thread's four lanes ((l0 + l1) + (l2 + l3)), then
//     shuffles at 1, 2, 4, 8 and 16, then a CTA group's 8 warps in the same
//     tree through shared memory; sums over x, y, z left to right, true
//     divisions, IEEE sqrtf, amin/amax's NaN rules. The pool's glue rides
//     in the same launch: the lane bound divided by clamp(s, 1e-12), the
//     enabled column from an int mask, and the block's minimum scale over
//     its valid lanes (smin).
//   rpt_live_cull (live_cull_kernel): every (ray block, chunk) pair. A
//     thread takes one chunk, for each of its warp's blocks (up to
//     kMaxBlocks) reads the chunk's sphere and runs the block's `sub` cone
//     tests against it (operation for operation as
//     live_cull_plain: the sums written out left to right, IEEE sqrtf and
//     division, torch.clamp's and amin's NaN rules), then the all-masked
//     drop, the segment cull against the cone's bound (+1e-3), the min over
//     the overlapping cones (INF elsewhere) and any-overlap; for the pool,
//     the chunk's object row of the table (cobj), the block's minimum scale
//     (smin) and the object's enabled flag. No (cone, chunk) value leaves
//     the registers. Two variants:
//       flat:  writes the block-level floor and overlap (B, C);
//       super: a warp holds 32 consecutive chunks, so for each block
//              __ballot_sync of the overlap flags is the packed bit word
//              (bit i = chunk 32w + i, bit 31 the sign bit, as pack_bits);
//              supers of S chunks (S dividing 32, or a multiple of it, the
//              warp then walking S / 32 words) reduce by shuffles to their
//              floor (min, INF-padded past C) and liveness (any).
//     Both variants first run a group pre-test (below): for a block whose
//     cones cannot overlap any of the warp's 32 chunks the warp writes what
//     the dense tests would (floor INF, not live, bit word 0) without
//     running them.
//   rpt_bucket_order (bucket_order_kernel): one CTA per block, any entry
//     count, in three passes over tiles of 256 entries: lo = min over every
//     entry, hi = max over the live ones, count; each entry's bucket and
//     floor in the twin's exact operations (a saturating float -> int, dead
//     entries to bucket 16) and a shared-memory histogram; then a stable
//     scatter: per tile, __match_any_sync ranks each entry among the lanes
//     of its warp with the same bucket, the warps' per-bucket counts give
//     the warp offsets, and running per-bucket bases carry across tiles, so
//     the order is by bucket, then by entry id, as the twin's scatter_ of a
//     one-hot cumsum gives it.
//
// What bounds them: bytes, for the table: its rays (24 bytes a lane and
// object, 12 where the origin is shared), the mask, the lane bound and the
// scales read once, 48 bytes a row written. Operations, for the cull. A
// cone test is about 30 fp32 operations, two of them IEEE square roots and
// two IEEE divisions, each a short instruction sequence under -fmad=false,
// so 60-100 instructions a (cone, chunk) pair; the spheres and the cone
// rows it reads are small and stay in L1/L2 (a warp's lanes read one cone
// row: a broadcast), and it writes 5 bytes a (block, chunk) pair (flat) or
// one bit and 5 bytes a (block, super) pair. The sort moves 5 bytes in and
// 8 out an entry, a few dozen operations each: bytes and latency bound,
// small beside the cull. The sort runs at 10-15% of that bound: latency,
// its five CTA barriers a tile. Three forms with a warp per row, no CTA
// barrier and the row in registers were each slower on every path (1.0-1.9x,
// PERF.md): 768 rows give 768 warps, about 1.5 for each of the card's 528
// schedulers, so a row's dependent chain (per 32 entries an IEEE division,
// five ballots and a shuffle) runs exposed, where the CTA form spreads a
// row over 8 warps.
// Most (block, 32-chunk group) pairs hold no live chunk (98.4% and 99.6%
// on the large mesh's two builds), so the cull spends its issue slots on
// the group pre-test instead. A first design built the group's sphere (two
// shuffle reductions) for every (block, group) pair and tested one block's
// 8 cones on 8 lanes: that cost half a dense group. So a warp takes its
// group against up to kMaxBlocks blocks: one sphere for all of them, 4
// blocks' cones a round on its 32 lanes, and the dense tests only for the
// blocks that may overlap (fewer blocks a warp where the launch would
// otherwise keep under kMinWarps warps).
//
// The group pre-test (group_verdicts; its plain form is
// mesh_kernels.group_may_overlap_plain, in the same operations). The warp
// builds one sphere (cg, R) around its group's real chunk spheres (lanes
// past C take no part): cg the middle of their box (shuffle min/max of
// c -/+ r), R the largest |c - cg| + r times (1 + M). Each lane tests one
// cone of one block against it in the dense test's form with margins, and
// a ballot gives each block's verdict. A (block, group) pair that no cone
// of the block may overlap writes each chunk as the
// dense test leaves a chunk whose every cone test is false: floor INF (the
// pool: on ? INF * smin : INF, the dense expression, so a zero or NaN smin
// gives what the twin gives), not live; its bit word 0. Every other pair
// runs block_chunk unchanged, so the outputs equal the dense kernel's, and
// the twin's, bit for bit by construction: the pre-test only has to be
// sound, "group dead" implying that every dense cone test of its chunks is
// false in float32. A pool group whose chunks belong to two objects is not
// tested (__all_sync on cobj). Why it is sound, with u = 2^-24, K = kKappa
// = 2^-7, T = kTau = 2^-16, M = kMu = 2^-18:
//  1. Containment. The float |c - cg| + r is within 6u of the exact value
//     and (1 + M) = 1 + 64u covers it, so every real chunk sphere lies in
//     (cg, R), and with o_rad added to both radii the chunk's test sphere
//     lies in the group's. The dense test is exact geometry on the table's
//     numbers (cos_a^2 + sin_a^2 = 1 within 3u): a sphere overlaps the cone
//     if the apex lies in it (dlen <= r), or if the angle between d and the
//     axis is at most a + b (sin b = r / dlen), or if a + b >= pi (the wrap,
//     cos_b <= -cos_a). A sphere inside another subtends a cap inside the
//     other's, so in exact arithmetic each clause that holds for a chunk
//     holds for the group, and the group's dlen - r is at most the chunk's.
//  2. The dense test's rounding. cos_d is within 10u of its exact value,
//     sin_b within 6u relative, cos_b within 7u / cos_b + u and the right
//     side cos_a cos_b - sin_a sin_b within 7u / cos_b + 12u. A chunk whose
//     exact r / dlen is at least 1 - K / 4 is caught by the group's
//     containment clause (its margin 2K dl; dG - RG <= d - r <= (K / 4)(dG
//     + RG)). Every other chunk has cos_b > 2^-4, so a float overlap by the
//     angle clause means an exact cos(angle) >= cos(a + b) - e, e < 2^-16.9,
//     an angle within eta <= 2 asin(sqrt(e / 2)) < 2^-7.9 of a + b (the
//     worst case at a + b = 0; less elsewhere); and by the wrap clause, b
//     within the same eta of pi - a.
//  3. The group's margins. sin_b + K raises the group's angle b by at least
//     K > eta, so with 1. its exact angle clause (or wrap) holds with room
//     K - eta. Outside its own containment clause (dlen > r + 2K dl) its
//     sin_b stays below 1 - K, cos_b above 2^-3, and its own rounding moves
//     both sides of its comparisons by less than 80u < T, which the
//     comparisons give away. The segment cull: the float dlen - r of chunk
//     and group are within 8u (dlen + r) of the exact values, which M (dlen
//     + r) covers, so a group whose mind exceeds bound + 1e-3 by that
//     margin has every chunk's mind above it. A cone with has_valid 0 is
//     dead for every chunk.
//  Every "dead" comparison is false on a NaN, so a NaN anywhere (a NaN
//  sphere, an infinite radius, a NaN cone row) reads as "may overlap" and
//  the group runs dense. The stated bounds hold for radii 1e-4 to 1e2 and
//  distances up to 1e3 with room; the CPU tests hold the implication on
//  tangent, apex-inside, wrap, bound-edge, masked, NaN and ragged groups.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCols = 12;   // a cone row: apex(3) axis(3) cos_a sin_a o_rad bound has_valid enabled
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 16;  // live buckets; dead entries go to bucket kBuckets
// the group pre-test's margins (see above; mesh_kernels.GROUP_KAPPA, _TAU, _MU)
constexpr float kKappa = 1.0f / 128.0f;
constexpr float kTau = 1.0f / 65536.0f;
constexpr float kMu = 1.0f / 262144.0f;
constexpr unsigned kFull = 0xffffffffu;
// Blocks a warp culls its group against, at most, and the warps a launch
// keeps before a warp takes more than one (16 blocks, or keeping 2,048
// warps, were slower on the large mesh and the pool: PERF.md).
constexpr int kMaxBlocks = 8;
constexpr int kMinWarps = 4096;

inline cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// torch.amin / amax: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// Cone row q against chunk sphere s: overlap, and *mind the clamped distance.
__device__ __forceinline__ bool cone_test(const float* q, float4 s, bool use_bound,
                                          float* mind_out) {
  const float r = s.w + q[8];
  const float d0 = s.x - q[0], d1 = s.y - q[1], d2 = s.z - q[2];
  const float dlen = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float mind = clamp_min(dlen - r, 0.0f);
  const float dl = clamp_min(dlen, 1e-12f);
  const float cos_d = (d0 * q[3] + d1 * q[4] + d2 * q[5]) / dl;
  const float sin_b = clamp_max(r / dl, 1.0f);
  const float cos_b = sqrtf(clamp_min(1.0f - sin_b * sin_b, 0.0f));
  // a + b >= pi (cos_b <= -cos_a) would wrap cos(a + b): always overlap.
  bool over = (dlen <= r) | (cos_b <= -q[6]) | (cos_d >= q[6] * cos_b - q[7] * sin_b);
  over = over & (q[10] != 0.0f);
  if (use_bound) over = over & (mind <= q[9] + 1e-3f);
  *mind_out = mind;
  return over;
}

struct Cull {
  const float4* spheres;  // (C, 4)
  int C;
  const float* table;     // (O, B * sub, kCols)
  int B;
  int sub;
  const int* cobj;        // (C,) object slot of each chunk, or null (one object)
  const float* smin;      // (O, B) the block's minimum scale per object, or null
  bool use_bound;
};

// Block b against chunk k: the floor (min over the overlapping cones, INF if
// none) and any-overlap, as live_cull_plain reduces them.
__device__ __forceinline__ bool block_chunk(const Cull& p, int b, int k, float* floor_out) {
  const float4 s = __ldg(p.spheres + k);
  const int g = p.cobj ? __ldg(p.cobj + k) : 0;
  const size_t first = (static_cast<size_t>(g) * p.B + b) * p.sub;
  float m = 0.0f;
  bool any = false;
  float q[kCols];
  for (int j = 0; j < p.sub; ++j) {
    const float4* row = reinterpret_cast<const float4*>(p.table + (first + j) * kCols);
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const float4 v = __ldg(row + i);
      q[4 * i] = v.x;
      q[4 * i + 1] = v.y;
      q[4 * i + 2] = v.z;
      q[4 * i + 3] = v.w;
    }
    float mind;
    const bool over = cone_test(q, s, p.use_bound, &mind);
    const float v = over ? mind : rpt::kInf;
    m = j == 0 ? v : nan_min(m, v);
    any = any | over;
  }
  if (p.smin) {  // the pool: floors in shared units; a disabled object is dead
    const bool on = q[11] != 0.0f;
    m = on ? m * __ldg(p.smin + static_cast<size_t>(g) * p.B + b) : rpt::kInf;
    any = any & on;
  }
  *floor_out = m;
  return any;
}

// The group pre-test for the warp's group of 32 chunks (lane i holds chunk
// k, real where k < C) against blocks b_first .. b_first + nb - 1 (nb <=
// kMaxBlocks): bit i of the result set where a cone of block b_first + i
// may overlap a chunk of the group. The group's sphere is built once;
// lanes then test 32 / sub blocks' cones a round (lane l: cone l % sub of
// block l / sub; sub > 32: one block a round, a lane looping over its
// cones). Every lane of the warp calls it and gets the same answer, and
// *n_dead gains the blocks found dead.
__device__ __forceinline__ unsigned group_verdicts(const Cull& p, int b_first, int nb, int k,
                                                   bool real, int lane, int* n_dead) {
  const float inf = __int_as_float(0x7f800000);
  const unsigned every = (1u << nb) - 1u;
  const float4 s = real ? __ldg(p.spheres + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int g = p.cobj && real ? __ldg(p.cobj + k) : 0;
  if (p.cobj) {  // a group across two objects runs dense
    const int g0 = __shfl_sync(kFull, g, 0);
    if (!__all_sync(kFull, !real || g == g0)) return every;
    g = g0;
  }
  float lo0 = real ? s.x - s.w : inf, lo1 = real ? s.y - s.w : inf, lo2 = real ? s.z - s.w : inf;
  float hi0 = real ? s.x + s.w : -inf, hi1 = real ? s.y + s.w : -inf;
  float hi2 = real ? s.z + s.w : -inf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo0 = nan_min(lo0, __shfl_xor_sync(kFull, lo0, off));
    lo1 = nan_min(lo1, __shfl_xor_sync(kFull, lo1, off));
    lo2 = nan_min(lo2, __shfl_xor_sync(kFull, lo2, off));
    hi0 = nan_max(hi0, __shfl_xor_sync(kFull, hi0, off));
    hi1 = nan_max(hi1, __shfl_xor_sync(kFull, hi1, off));
    hi2 = nan_max(hi2, __shfl_xor_sync(kFull, hi2, off));
  }
  const float c0 = (lo0 + hi0) * 0.5f, c1 = (lo1 + hi1) * 0.5f, c2 = (lo2 + hi2) * 0.5f;
  const float e0 = s.x - c0, e1 = s.y - c1, e2 = s.z - c2;
  float rad = real ? sqrtf(e0 * e0 + e1 * e1 + e2 * e2) + s.w : -inf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rad = nan_max(rad, __shfl_xor_sync(kFull, rad, off));
  rad = rad * (1.0f + kMu);
  const int width = p.sub < 32 ? p.sub : 32;  // lanes a block takes in a round
  const int per = 32 / width;                 // blocks a round
  const unsigned lanes = width == 32 ? kFull : (1u << width) - 1u;
  unsigned may = 0;
  for (int i0 = 0; i0 < nb; i0 += per) {
    const int i = i0 + lane / width;
    bool dead = true;
    if (lane < per * width && i < nb) {
      const size_t first = (static_cast<size_t>(g) * p.B + b_first + i) * p.sub;
      for (int j = lane % width; j < p.sub; j += width) {
        const float* q = p.table + (first + j) * kCols;
        const float r = rad + __ldg(q + 8);
        const float d0 = c0 - __ldg(q), d1 = c1 - __ldg(q + 1), d2 = c2 - __ldg(q + 2);
        const float dlen = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        const float dl = clamp_min(dlen, 1e-12f);
        const float cos_d = (d0 * __ldg(q + 3) + d1 * __ldg(q + 4) + d2 * __ldg(q + 5)) / dl;
        const float sin_b = clamp_max(r / dl + kKappa, 1.0f);
        const float cos_b = sqrtf(clamp_min(1.0f - sin_b * sin_b, 0.0f));
        const float cos_a = __ldg(q + 6), sin_a = __ldg(q + 7);
        // every comparison false on a NaN: a NaN never makes a cone dead
        bool cone_dead = (dlen > r + 2.0f * kKappa * dl) & (cos_b > -cos_a + kTau) &
                         (cos_d < cos_a * cos_b - sin_a * sin_b - kTau);
        cone_dead = cone_dead | (__ldg(q + 10) == 0.0f);
        if (p.use_bound) {
          cone_dead = cone_dead | ((dlen - r) - kMu * (dlen + r) > __ldg(q + 9) + 1e-3f);
        }
        dead = dead & cone_dead;
      }
    }
    const unsigned alive = __ballot_sync(kFull, !dead);
    for (int t = 0; t < per && i0 + t < nb; ++t) {
      if ((alive >> (t * width)) & lanes) may |= 1u << (i0 + t);
    }
  }
  *n_dead += nb - __popc(may);
  return may;
}

// The floor a chunk k of block b gets when every cone test is false, as
// block_chunk computes it: INF, scaled for the pool as there.
__device__ __forceinline__ float dead_floor(const Cull& p, int b, int k) {
  float m = rpt::kInf;
  if (p.smin) {
    const int g = __ldg(p.cobj + k);
    const size_t last = (static_cast<size_t>(g) * p.B + b) * p.sub + p.sub - 1;
    const bool on = __ldg(p.table + last * kCols + 11) != 0.0f;
    m = on ? m * __ldg(p.smin + static_cast<size_t>(g) * p.B + b) : rpt::kInf;
  }
  return m;
}

// Flat: one thread per chunk, a warp a group of 32 (kThreads is a multiple
// of 32), against blocks blockIdx.y * nblk .. + nblk - 1.
__global__ void __launch_bounds__(kThreads)
live_cull_kernel(Cull p, int nblk, float* __restrict__ mind, bool* __restrict__ over,
                 int* __restrict__ skipped) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k - lane >= p.C) return;  // the whole warp lies past C
  const int b_first = blockIdx.y * nblk;
  const int nb = min(nblk, p.B - b_first);
  const bool real = k < p.C;
  int n_dead = 0;
  const unsigned may = group_verdicts(p, b_first, nb, k, real, lane, &n_dead);
  if (skipped != nullptr && lane == 0 && n_dead > 0) atomicAdd(skipped, n_dead);
  if (!real) return;
#pragma unroll 1
  for (int i = 0; i < nb; ++i) {
    const int b = b_first + i;
    float m;
    bool o = false;
    if ((may >> i) & 1u) {
      o = block_chunk(p, b, k, &m);
    } else {
      m = dead_floor(p, b, k);
    }
    const size_t at = static_cast<size_t>(b) * p.C + k;
    mind[at] = m;
    over[at] = o;
  }
}

// Super: one warp per group of G = max(S, 32) consecutive chunks against
// blocks blockIdx.y * nblk .. + nblk - 1: their bit words (those below W)
// and their supers' floors and liveness (those below C_s), when the floor
// outputs are given. The pre-test decides per 32-chunk word. (Reducing a
// block's supers as soon as its word is done, for S <= 32, took 64
// registers and no spills where this takes 80 and spills 24 bytes, and
// was 3-6% slower on the large mesh.)
__global__ void __launch_bounds__(kThreads)
live_cull_super_kernel(Cull p, int S, int W, int n_groups, int nblk, int* __restrict__ bits,
                       float* __restrict__ sfloor, bool* __restrict__ sover,
                       int* __restrict__ skipped) {
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (group >= n_groups) return;  // the whole warp
  const int b_first = blockIdx.y * nblk;
  const int nb = min(nblk, p.B - b_first);
  const int G = S > 32 ? S : 32;
  const int words = G / 32;
  float m[kMaxBlocks];
  bool any[kMaxBlocks];
  unsigned dense = 0;  // blocks for which some word ran its cone tests
  int n_dead = 0;
  for (int w = 0; w < words; ++w) {
    const int word = group * words + w;
    const int k = word * 32 + lane;
    const bool real = k < p.C;  // past C: INF and dead, as _pad_cols pads
    const bool tested = word * 32 < p.C;
    const unsigned may = tested ? group_verdicts(p, b_first, nb, k, real, lane, &n_dead) : 0u;
    dense |= may;
#pragma unroll
    for (int i = 0; i < kMaxBlocks; ++i) {
      if (i >= nb) break;
      const int b = b_first + i;
      float f = rpt::kInf;
      bool o = false;
      if ((may >> i) & 1u) {
        if (real) o = block_chunk(p, b, k, &f);
      } else if (real) {
        f = dead_floor(p, b, k);
      }
      const unsigned ballot = __ballot_sync(kFull, o);
      if (lane == 0 && word < W) bits[static_cast<size_t>(b) * W + word] = static_cast<int>(ballot);
      m[i] = w == 0 ? f : nan_min(m[i], f);
      any[i] = (w == 0 ? false : any[i]) | o;
    }
  }
  if (skipped != nullptr && lane == 0 && n_dead > 0) atomicAdd(skipped, n_dead);
  if (sfloor == nullptr) return;
  const int width = S < 32 ? S : 32;  // lanes of one super
  const int n_super = (p.C + S - 1) / S;
  const int sp = (group * G + lane) / S;
#pragma unroll
  for (int i = 0; i < kMaxBlocks; ++i) {
    if (i >= nb) break;
    float mi = m[i];
    bool ai = any[i];
    // a block no word ran dense holds INF and dead on every lane (the pool
    // aside): the reduction's result as it stands (reducing every block
    // made the large mesh's cull 23% slower: PERF.md)
    if (((dense >> i) & 1u) || p.smin != nullptr) {
      for (int off = 1; off < width; off <<= 1) {
        mi = nan_min(mi, __shfl_xor_sync(kFull, mi, off));
        ai = ai | (__shfl_xor_sync(kFull, static_cast<int>(ai), off) != 0);
      }
    }
    if (lane % width == 0 && sp < n_super) {
      const size_t at = static_cast<size_t>(b_first + i) * n_super + sp;
      sfloor[at] = mi;
      sover[at] = ai;
    }
  }
}

// Blocks a warp takes: the most (up to kMaxBlocks) that leave at least
// kMinWarps warps in the launch, so the group's sphere is built once for
// several blocks where there is parallelism to spare.
inline int blocks_per_warp(int groups, int B) {
  int nblk = kMaxBlocks;
  while (nblk > 1 && static_cast<long long>(groups) * ((B + nblk - 1) / nblk) < kMinWarps) {
    nblk /= 2;
  }
  return nblk;
}

// An entry's bucket: ((m - lo) / span) * 15, negative and NaN to 0, capped
// at 15, truncated (the twin's saturating float -> int).
__device__ __forceinline__ int bucket_of(float m, float lo, float span) {
  const float x = (m - lo) / span * static_cast<float>(kBuckets - 1);
  float c = x > 0.0f ? x : 0.0f;
  c = c > static_cast<float>(kBuckets - 1) ? static_cast<float>(kBuckets - 1) : c;
  return static_cast<int>(c);
}

__global__ void __launch_bounds__(kThreads)
bucket_order_kernel(const float* __restrict__ mind, const bool* __restrict__ over, int n,
                    int* __restrict__ order, float* __restrict__ key, int* __restrict__ counts) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_base[kBuckets + 1];
  __shared__ int s_wcount[kWarps][kBuckets + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float* m_row = mind + row;
  const bool* o_row = over + row;

  // --- lo over every entry, hi over the live ones, the live count ----------
  float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
  int cnt = 0;
  for (int e = tid; e < n; e += kThreads) {
    const float m = m_row[e];
    const bool o = o_row[e];
    lo = nan_min(lo, m);
    hi = nan_max(hi, o ? m : -rpt::kInf);
    cnt += o;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_cnt[warp] = cnt;
  }
  if (tid <= kBuckets) s_base[tid] = 0;
  for (int i = tid; i < kWarps * (kBuckets + 1); i += kThreads) (&s_wcount[0][0])[i] = 0;
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  cnt = s_cnt[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = nan_min(lo, s_lo[w]);
    hi = nan_max(hi, s_hi[w]);
    cnt += s_cnt[w];
  }
  const float span = clamp_min(hi - lo, 1e-6f);
  const float step = span / static_cast<float>(kBuckets - 1);
  if (tid == 0) counts[blockIdx.x] = cnt;

  // --- floors by entry id, and the bucket histogram -------------------------
  for (int e = tid; e < n; e += kThreads) {
    const int bk = bucket_of(m_row[e], lo, span);
    key[row + e] = lo + static_cast<float>(bk) * step;
    atomicAdd(&s_base[o_row[e] ? bk : kBuckets], 1);
  }
  __syncthreads();
  if (tid == 0) {  // exclusive scan of the counts
    int acc = 0;
    for (int k = 0; k <= kBuckets; ++k) {
      const int c = s_base[k];
      s_base[k] = acc;
      acc += c;
    }
  }
  __syncthreads();

  // --- stable scatter, a tile of kThreads entries at a time ------------------
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int e = t0 + tid;
    int bk = kBuckets + 1;  // past the end: a bucket of its own, never written
    if (e < n) bk = o_row[e] ? bucket_of(m_row[e], lo, span) : kBuckets;
    const unsigned peers = __match_any_sync(0xffffffffu, bk);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (rank == 0 && e < n) s_wcount[warp][bk] = __popc(peers);
    __syncthreads();
    if (e < n) {
      int pos = s_base[bk] + rank;
      for (int w = 0; w < warp; ++w) pos += s_wcount[w][bk];
      order[row + pos] = e;
    }
    __syncthreads();
    if (tid <= kBuckets) {
      int add = 0;
      for (int w = 0; w < kWarps; ++w) {
        add += s_wcount[w][tid];
        s_wcount[w][tid] = 0;
      }
      s_base[tid] += add;
    }
    __syncthreads();
  }
}

// --- rpt_cone_table -------------------------------------------------------------

// Where the table reads its rays and writes its rows: element strides of d
// and o (object, component, lane), of the lane bound and the scales
// (object, lane), each possibly 0 (a broadcast).
struct ConeArgs {
  const float* d;
  int d_so, d_sc, d_sl;
  const float* o;
  int o_so, o_sc, o_sl;
  const bool* valid;  // (n_pad,) or null
  const float* lb;    // the lane bound, or null
  int lb_so, lb_sl;
  const float* s;     // the pool's scales (O, n_pad), or null
  int s_so, s_sl;
  const int* enabled;  // (O,) or null
  int n_pad;
  float* rows;  // (O, n_pad / lanes, kCols)
  float* smin;  // (O, n_pad / 1024), with s
};

// Lanes l0 .. l0 + 3 of one component: a 16-byte load where they are
// consecutive and aligned, else four loads (a stride-0 origin reads one
// address four times).
__device__ __forceinline__ void load4(const float* p, int sl, float (&x)[4]) {
  if (sl == 1 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __ldg(p + static_cast<long long>(k) * sl);
  }
}

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return nan_min(a, b); }
};

// The reduction of v[i] (a thread's partial of its four lanes) over the
// group: shuffles at 1, 2, 4, 8 and 16 (a warp's 128 lanes), then, for a
// CTA group, the 8 warps' partials in the tree's order through shared
// memory. For Sum this is the twin's pairwise tree (mesh_kernels._tree_sum):
// a thread's four lanes make its level-2 node, xor-partners are siblings at
// each level, and a + b == b + a, so every thread ends with the same bits.
template <bool kCta, int N, class Op>
__device__ __forceinline__ void group_reduce(float (&v)[N], Op op, float (*red)[kWarps],
                                             int lane, int warp) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) v[i] = op(v[i], __shfl_xor_sync(kFull, v[i], off));
  }
  if (!kCta) return;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* r = red[i];
    v[i] = op(op(op(r[0], r[1]), op(r[2], r[3])), op(op(r[4], r[5]), op(r[6], r[7])));
  }
}

// A warp per 128-lane group (8 groups a CTA), or the CTA's 8 warps per
// 1024-lane group (kCta); thread l of warp w holds lanes 4l .. 4l + 3 of
// the CTA's w-th 128. The CTA covers one 1024-lane block of one object
// (blockIdx.x, blockIdx.y), which also gives the block's smin. Operation
// for operation as cone_table_plain.
template <bool kCta>
__global__ void __launch_bounds__(kThreads) cone_table_kernel(ConeArgs a) {
  __shared__ float red[8][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int obj = blockIdx.y;
  const long long l0 = static_cast<long long>(blockIdx.x) * rpt::kNB + warp * 128 + lane * 4;
  float d[3][4], o[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    load4(a.d + obj * static_cast<long long>(a.d_so) + c * static_cast<long long>(a.d_sc) +
              l0 * a.d_sl, a.d_sl, d[c]);
    load4(a.o + obj * static_cast<long long>(a.o_so) + c * static_cast<long long>(a.o_sc) +
              l0 * a.o_sl, a.o_sl, o[c]);
  }
  bool v[4] = {true, true, true, true};
  float has_valid = 1.0f;
  if (a.valid != nullptr) {
    const unsigned char* vp = reinterpret_cast<const unsigned char*>(a.valid) + l0;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(vp + k) != 0;
    // masked lanes take the mean of their group's valid ones
    float r[7];
    r[0] = static_cast<float>(v[0] + v[1] + v[2] + v[3]);  // counts: exact in float
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[1 + c] = ((v[0] ? o[c][0] : 0.0f) + (v[1] ? o[c][1] : 0.0f)) +
                 ((v[2] ? o[c][2] : 0.0f) + (v[3] ? o[c][3] : 0.0f));
      r[4 + c] = ((v[0] ? d[c][0] : 0.0f) + (v[1] ? d[c][1] : 0.0f)) +
                 ((v[2] ? d[c][2] : 0.0f) + (v[3] ? d[c][3] : 0.0f));
    }
    group_reduce<kCta>(r, Sum(), red, lane, warp);
    const float nv = r[0] < 1.0f ? 1.0f : r[0];
    has_valid = r[0] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float om = r[1 + c] / nv, dm = r[4 + c] / nv;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[c][k] = v[k] ? o[c][k] : om;
        d[c][k] = v[k] ? d[c][k] : dm;
      }
    }
  }
  // the apex (the origins' mean) and the directions' mean
  float r[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = (o[c][0] + o[c][1]) + (o[c][2] + o[c][3]);
    r[3 + c] = (d[c][0] + d[c][1]) + (d[c][2] + d[c][3]);
  }
  group_reduce<kCta>(r, Sum(), red, lane, warp);
  const float lanes = kCta ? 1024.0f : 128.0f;
  const float oc[3] = {r[0] / lanes, r[1] / lanes, r[2] / lanes};
  const float mean[3] = {r[3] / lanes, r[4] / lanes, r[5] / lanes};
  const float den = clamp_min(sqrtf(mean[0] * mean[0] + mean[1] * mean[1] + mean[2] * mean[2]),
                              1e-12f);
  const float ax[3] = {mean[0] / den, mean[1] / den, mean[2] / den};
  // o_rad^2 and the bound (max), cos_a (min)
  float mx[2], mn[1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e0 = o[0][k] - oc[0], e1 = o[1][k] - oc[1], e2 = o[2][k] - oc[2];
    const float r2 = e0 * e0 + e1 * e1 + e2 * e2;
    const float cs = d[0][k] * ax[0] + d[1][k] * ax[1] + d[2][k] * ax[2];
    float b = 0.0f;
    if (a.lb != nullptr) {
      b = __ldg(a.lb + obj * static_cast<long long>(a.lb_so) + (l0 + k) * a.lb_sl);
      if (a.s != nullptr) {
        b = b / clamp_min(__ldg(a.s + obj * static_cast<long long>(a.s_so) + (l0 + k) * a.s_sl),
                          1e-12f);
      }
    }
    mx[0] = k == 0 ? r2 : nan_max(mx[0], r2);
    mx[1] = k == 0 ? b : nan_max(mx[1], b);
    mn[0] = k == 0 ? cs : nan_min(mn[0], cs);
  }
  group_reduce<kCta>(mx, Max(), red, lane, warp);
  group_reduce<kCta>(mn, Min(), red, lane, warp);
  if (a.s != nullptr) {  // the block's minimum scale over its valid lanes: the CTA's
    float sm[1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sk = __ldg(a.s + obj * static_cast<long long>(a.s_so) + (l0 + k) * a.s_sl);
      const float x = v[k] ? sk : rpt::kInf;
      sm[0] = k == 0 ? x : nan_min(sm[0], x);
    }
    group_reduce<true>(sm, Min(), red, lane, warp);
    if (threadIdx.x == 0) {
      a.smin[static_cast<size_t>(obj) * gridDim.x + blockIdx.x] = sm[0];
    }
  }
  if (lane != 0 || (kCta && warp != 0)) return;
  const float cos_a = mn[0];
  const float on = a.enabled == nullptr || __ldg(a.enabled + obj) != 0 ? 1.0f : 0.0f;
  const int G = a.n_pad / (kCta ? 1024 : 128);
  const int g = kCta ? blockIdx.x : blockIdx.x * kWarps + warp;
  float4* out = reinterpret_cast<float4*>(a.rows + (static_cast<size_t>(obj) * G + g) * kCols);
  out[0] = make_float4(oc[0], oc[1], oc[2], ax[0]);
  out[1] = make_float4(ax[1], ax[2], cos_a, sqrtf(clamp_min(1.0f - cos_a * cos_a, 0.0f)));
  out[2] = make_float4(sqrtf(mx[0]), mx[1], has_valid, on);
}

}  // namespace

// S == 0: the flat variant, into mind/over (B, C). S > 0: the super variant,
// into bits (B, W) and, where sfloor/sover are given, (B, ceil(C / S)).
// skipped, where given (one int on the card), gains the (block, 32-chunk
// group) pairs whose dense tests the pre-test skipped.
extern "C" int rpt_live_cull(const void* spheres, int C, const void* table, int B, int sub,
                             const void* cobj, const void* smin, int use_bound, int S, int W,
                             void* mind, void* over, void* bits, void* sfloor, void* sover,
                             void* skipped, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || sub <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(spheres) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Cull p{static_cast<const float4*>(spheres), C, static_cast<const float*>(table), B, sub,
               static_cast<const int*>(cobj), static_cast<const float*>(smin), use_bound != 0};
  if (S == 0) {
    const int nblk = blocks_per_warp((C + 31) / 32, B);
    const dim3 grid((C + kThreads - 1) / kThreads, (B + nblk - 1) / nblk);
    live_cull_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
        p, nblk, static_cast<float*>(mind), static_cast<bool*>(over), static_cast<int*>(skipped));
    return static_cast<int>(cudaGetLastError());
  }
  if (S < 0 || (S < 32 ? 32 % S : S % 32) != 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = S > 32 ? S : 32;
  const int by_c = (C + G - 1) / G, by_w = (W * 32 + G - 1) / G;
  const int n_groups = by_c > by_w ? by_c : by_w;
  const int nblk = blocks_per_warp(n_groups, B);
  const dim3 grid((n_groups + kWarps - 1) / kWarps, (B + nblk - 1) / nblk);
  live_cull_super_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      p, S, W, n_groups, nblk, static_cast<int*>(bits), static_cast<float*>(sfloor),
      static_cast<bool*>(sover), static_cast<int*>(skipped));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_bucket_order(const void* mind, const void* over, int B, int n, void* order,
                                void* key, void* counts, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  bucket_order_kernel<<<B, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(mind), static_cast<const bool*>(over), n,
      static_cast<int*>(order), static_cast<float*>(key), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The cone rows (O, n_pad / lanes, 12) of rays d / o (O, 3, n_pad) read
// through their strides, lanes 128 or 1024, n_pad a multiple of 1024; with
// s, also smin (O, n_pad / 1024).
extern "C" int rpt_cone_table(const void* d, int d_so, int d_sc, int d_sl, const void* o,
                              int o_so, int o_sc, int o_sl, const void* valid, const void* lb,
                              int lb_so, int lb_sl, const void* s, int s_so, int s_sl,
                              const void* enabled, int O, int n_pad, int lanes, void* rows,
                              void* smin, void* stream) {
  if (O <= 0 || n_pad <= 0) return static_cast<int>(cudaSuccess);
  if (O > 65535 || n_pad % rpt::kNB != 0 || (lanes != 128 && lanes != rpt::kNB) ||
      (s != nullptr && smin == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const ConeArgs a{static_cast<const float*>(d), d_so, d_sc, d_sl,
                   static_cast<const float*>(o), o_so, o_sc, o_sl,
                   static_cast<const bool*>(valid), static_cast<const float*>(lb), lb_so, lb_sl,
                   static_cast<const float*>(s), s_so, s_sl, static_cast<const int*>(enabled),
                   n_pad, static_cast<float*>(rows), static_cast<float*>(smin)};
  const dim3 grid(n_pad / rpt::kNB, O);
  if (lanes == 128) {
    cone_table_kernel<false><<<grid, kThreads, 0, as_stream(stream)>>>(a);
  } else {
    cone_table_kernel<true><<<grid, kThreads, 0, as_stream(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
