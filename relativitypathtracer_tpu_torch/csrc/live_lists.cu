// K4: the live-chunk list build, in two kernels.
//
// Replaces the XLA half of the TPU's hot path in
// relativitypathtracer_tpu/ops/pallas/mesh_kernels.py: live_chunk_lists
// (:389) with its cull _sub_cone_cull (:414) / _cone_cull (:145) and its
// 16-bucket counting sort bucket_order (:174); the two-level
// live_chunk_lists2 (:277) and live_chunk_lists3 (:332) with pack_bits
// (:218); and mesh_batch.py:118 live_chunk_lists_multi and mesh_large.py:120
// large_live_lists, which are built from them. The TPU runs them as dense
// XLA passes over (sub-cone, chunk) arrays; the port's plain twins
// (mesh_kernels.live_cull_plain, bucket_order_plain) do the same with torch
// ops, which on the large path made (6,144 x 10,240) temporaries of up to
// 755 MB in a dozen passes.
//
//   rpt_live_cull (live_cull_kernel): every (ray block, chunk) pair. A
//     thread takes one chunk of one block, reads the chunk's sphere and runs
//     the block's `sub` cone tests against it (operation for operation as
//     live_cull_plain: the sums written out left to right, IEEE sqrtf and
//     division, torch.clamp's and amin's NaN rules), then the all-masked
//     drop, the segment cull against the cone's bound (+1e-3), the min over
//     the overlapping cones (INF elsewhere) and any-overlap; for the pool,
//     the chunk's object row of the table (cobj), the block's minimum scale
//     (smin) and the object's enabled flag. The cone rows (apex, axis,
//     cos_a, sin_a, o_rad, bound, has_valid, enabled: 12 floats) come from
//     mesh_kernels.cone_table, torch code that the twin reads too, so kernel
//     and twin agree bit for bit. No (cone, chunk) value leaves the
//     registers. Two variants:
//       flat:  writes the block-level floor and overlap (B, C);
//       super: a warp holds 32 consecutive chunks of one block, so
//              __ballot_sync of the overlap flags is the packed bit word
//              (bit i = chunk 32w + i, bit 31 the sign bit, as pack_bits);
//              supers of S chunks (S dividing 32, or a multiple of it, the
//              warp then walking S / 32 words) reduce by shuffles to their
//              floor (min, INF-padded past C) and liveness (any).
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
// What bounds them: operations, for the cull. A cone test is about 30 fp32
// operations, two of them IEEE square roots and two IEEE divisions, each a
// short instruction sequence under -fmad=false, so 60-100 instructions a
// (cone, chunk) pair; the spheres and the cone rows it reads are small and
// stay in L1/L2 (a warp's lanes read one cone row: a broadcast), and it
// writes 5 bytes a (block, chunk) pair (flat) or one bit and 5 bytes a
// (block, super) pair. The sort moves 5 bytes in and 8 out an entry, a few
// dozen operations each: bytes and latency bound, small beside the cull.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCols = 12;   // a cone row: apex(3) axis(3) cos_a sin_a o_rad bound has_valid enabled
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 16;  // live buckets; dead entries go to bucket kBuckets

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

// Flat: one thread per (block, chunk); block b = blockIdx.y.
__global__ void __launch_bounds__(kThreads)
live_cull_kernel(Cull p, float* __restrict__ mind, bool* __restrict__ over) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= p.C) return;
  float m;
  const bool o = block_chunk(p, b, k, &m);
  const size_t at = static_cast<size_t>(b) * p.C + k;
  mind[at] = m;
  over[at] = o;
}

// Super: one warp per group of G = max(S, 32) consecutive chunks of block
// blockIdx.y: its bit words (those below W) and its supers' floors and
// liveness (those below C_s), when the floor outputs are given.
__global__ void __launch_bounds__(kThreads)
live_cull_super_kernel(Cull p, int S, int W, int n_groups, int* __restrict__ bits,
                       float* __restrict__ sfloor, bool* __restrict__ sover) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (group >= n_groups) return;  // the whole warp
  const int G = S > 32 ? S : 32;
  const int words = G / 32;
  float m = 0.0f;
  bool any = false;
  for (int w = 0; w < words; ++w) {
    const int word = group * words + w;
    const int k = word * 32 + lane;
    float f = rpt::kInf;  // past C: INF and dead, as _pad_cols pads
    bool o = false;
    if (k < p.C) o = block_chunk(p, b, k, &f);
    const unsigned ballot = __ballot_sync(0xffffffffu, o);
    if (lane == 0 && word < W) bits[static_cast<size_t>(b) * W + word] = static_cast<int>(ballot);
    m = w == 0 ? f : nan_min(m, f);
    any = any | o;
  }
  if (sfloor == nullptr) return;
  const int width = S < 32 ? S : 32;  // lanes of one super
  for (int off = 1; off < width; off <<= 1) {
    m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
    any = any | (__shfl_xor_sync(0xffffffffu, static_cast<int>(any), off) != 0);
  }
  const int n_super = (p.C + S - 1) / S;
  const int sp = (group * G + lane) / S;
  if (lane % width == 0 && sp < n_super) {
    const size_t at = static_cast<size_t>(b) * n_super + sp;
    sfloor[at] = m;
    sover[at] = any;
  }
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

}  // namespace

// S == 0: the flat variant, into mind/over (B, C). S > 0: the super variant,
// into bits (B, W) and, where sfloor/sover are given, (B, ceil(C / S)).
extern "C" int rpt_live_cull(const void* spheres, int C, const void* table, int B, int sub,
                             const void* cobj, const void* smin, int use_bound, int S, int W,
                             void* mind, void* over, void* bits, void* sfloor, void* sover,
                             void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || sub <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(spheres) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Cull p{static_cast<const float4*>(spheres), C, static_cast<const float*>(table), B, sub,
               static_cast<const int*>(cobj), static_cast<const float*>(smin), use_bound != 0};
  if (S == 0) {
    const dim3 grid((C + kThreads - 1) / kThreads, B);
    live_cull_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(p, static_cast<float*>(mind),
                                                                static_cast<bool*>(over));
    return static_cast<int>(cudaGetLastError());
  }
  if (S < 0 || (S < 32 ? 32 % S : S % 32) != 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = S > 32 ? S : 32;
  const int by_c = (C + G - 1) / G, by_w = (W * 32 + G - 1) / G;
  const int n_groups = by_c > by_w ? by_c : by_w;
  const dim3 grid((n_groups + kWarps - 1) / kWarps, B);
  live_cull_super_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      p, S, W, n_groups, static_cast<int*>(bits), static_cast<float*>(sfloor),
      static_cast<bool*>(sover));
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
