// K2 and K8: the bilinear texel fetch from the footprint atlas, one kernel.
//
// Replaces relativitypathtracer_tpu/ops/pallas/texture_kernel.py:
// _tex_kernel (footprint_sample_small, atlases of at most 1024 rows) and
// _tex_window_kernel (footprint_sample_windowed, larger atlases), together
// with the XLA-side address math both take as input (_address_lanes) and the
// renderer's per-object selection of the texture constants.
//
// On the TPU both kernels fetch rows through one-hot MXU products, because
// it has no fast gather; K8 exists only because a MID atlas does not fit in
// VMEM and must be walked in DMA windows. Here a lane reads its row directly:
// a MID atlas (65,536 rows x 32 B = 2 MB) stays in the 50 MB L2, and so does
// the part of a BIG one that a frame touches. So one kernel serves every
// atlas size, and neither the one-hot product nor the channel-split table is
// copied.
//
// What bounds it on this card: per lane it reads the object id (4 B), the uv
// (8 B) and one 16-byte footprint quad, and writes 12 bytes of RGB, with
// about 60 integer and fp32 operations: memory-bound, about 40 B per lane.
//
// Design: one thread per lane. The per-object table (tex_w, tex_h, the six
// footprint-region columns and the three tile_params columns; int32, O x 11)
// is staged in dynamic shared memory sized to the table (44 B a row, so a
// scene's few rows leave the SM's occupancy alone) when it has at most
// kMaxStaged rows, and read from global memory otherwise (the per-lane form
// the tests use, one row per lane). The address math is the JAX package's, in int32 with the same
// clamps; the atlas's footprint quads already hold the reference's clamped
// taps (models.scene._footprint_atlas), so no tap is re-derived. The four
// taps are weighted as _tex_kernel weights them, with -fmad=false so each
// product is rounded as in the plain PyTorch twin.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 11;         // TABLE_COLS
constexpr int kMaxStaged = 1024;  // table rows staged in shared memory (at most 44 KB)

__device__ __forceinline__ int interleave8(int x) {  // texture_layout._interleave8
  x = (x | (x << 4)) & 0x0F0F;
  x = (x | (x << 2)) & 0x3333;
  x = (x | (x << 1)) & 0x5555;
  return x;
}

__device__ __forceinline__ int clip(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ float channel(int texel, int shift) {
  return static_cast<float>((texel >> shift) & 0xFF) / 255.0f;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
footprint_kernel(const int4* __restrict__ quads, int rq, const int* __restrict__ table,
                 int n_table, const int* __restrict__ obj, const float* __restrict__ uv, int n,
                 float* __restrict__ rgb, int* __restrict__ quad_out) {
  extern __shared__ int s_tab[];  // n_table * kCols when staged, else unused
  if (kStaged) {
    for (int e = threadIdx.x; e < n_table * kCols; e += blockDim.x) s_tab[e] = table[e];
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int* c = (kStaged ? s_tab : table) + static_cast<size_t>(obj[lane]) * kCols;
  const int w = c[0], h = c[1];

  // _address_lanes
  const float u = static_cast<float>(w) * uv[lane];
  const float v = static_cast<float>(h) * (1.0f - uv[n + lane]);
  const int x = min(static_cast<int>(floorf(u)), w - 1);
  const int y = min(static_cast<int>(floorf(v)), h - 1);
  const float u_ratio = u - static_cast<float>(x);
  const float v_ratio = v - static_cast<float>(y);
  const int x0 = clip(x, 0, w - 1);
  const int y0 = clip(y, 0, h - 1);
  const int lx = clip(x0 - c[3], 0, max(c[6] - 1, 0));
  const int ly = clip(y0 - c[4], 0, max(c[7] - 1, 0));
  // tile_slot_fast with the region constants [sm1 ss r16]
  const int sm1 = c[8], ss = c[9], r16 = c[10];
  const int tx = lx >> 4, ty = ly >> 4;
  const int m = interleave8(tx & sm1) | (interleave8(ty & sm1) << 1);
  const int extra = ((tx * r16) >> 16) | ((ty * r16) >> 16);
  const int slot = (extra * ss + m) * 256 + (ly & 15) * 16 + (lx & 15);
  const int idx4 = clip((c[2] + slot) * 4, 0, rq * 8 - 4);
  const int quad = idx4 >> 2;  // 2 * row + hi_half

  // One 16-byte load: the lane's footprint quad (taps in reference order).
  const int4 q = __ldg(quads + quad);
  const float u_opp = 1.0f - u_ratio;
  const float v_opp = 1.0f - v_ratio;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int shift = 8 * ch;
    const float row1 = channel(q.x, shift) * u_opp + channel(q.y, shift) * u_ratio;
    const float row2 = channel(q.z, shift) * u_ratio + channel(q.w, shift) * u_opp;
    rgb[static_cast<size_t>(ch) * n + lane] = row1 * v_opp + row2 * v_ratio;
  }
  if (quad_out != nullptr) quad_out[lane] = quad;
}

}  // namespace

extern "C" int rpt_footprint_sample(const void* quads, int rq, const void* table, int n_table,
                                    const void* obj, const void* uv, int n, void* rgb,
                                    void* quad_out, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int4*>(quads);
  const auto* tab = static_cast<const int*>(table);
  if (n_table <= kMaxStaged) {
    const size_t smem = static_cast<size_t>(n_table) * kCols * sizeof(int);
    footprint_kernel<true><<<blocks, kThreads, smem, s>>>(
        q, rq, tab, n_table, static_cast<const int*>(obj), static_cast<const float*>(uv), n,
        static_cast<float*>(rgb), static_cast<int*>(quad_out));
  } else {
    footprint_kernel<false><<<blocks, kThreads, 0, s>>>(
        q, rq, tab, n_table, static_cast<const int*>(obj), static_cast<const float*>(uv), n,
        static_cast<float*>(rgb), static_cast<int*>(quad_out));
  }
  return static_cast<int>(cudaGetLastError());
}
