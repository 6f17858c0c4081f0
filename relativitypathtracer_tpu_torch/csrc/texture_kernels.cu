// K2 and K8: the bilinear texel fetch from the footprint atlas, one kernel,
// with the renderer's flat-colour select.
//
// Replaces relativitypathtracer_tpu/ops/pallas/texture_kernel.py:
// _tex_kernel (footprint_sample_small, atlases of at most 1024 rows) and
// _tex_window_kernel (footprint_sample_windowed, larger atlases), together
// with the XLA-side address math both take as input (_address_lanes), the
// renderer's per-object selection of the texture constants, and the select
// that follows the fetch (the JAX package's render.py,
// `jnp.where(textured, tex_rgb, flat_rgb)`).
//
// On the TPU both kernels fetch rows through one-hot MXU products, because
// it has no fast gather; K8 exists only because a MID atlas does not fit in
// VMEM and must be walked in DMA windows. Here a lane reads its row directly:
// a MID atlas (65,536 rows x 32 B = 2 MB) stays in the 50 MB L2, and so does
// the part of a BIG one that a frame touches. So one kernel serves every
// atlas size, and neither the one-hot product nor the channel-split table is
// copied.
//
// What bounds it on this card: the lanes' bytes. A lane reads its object id
// (4 B) and its uv (8 B) and writes 12 B of RGB; its 16-byte footprint quad
// comes from an atlas that L1/L2 hold (a 512-row atlas is 16 KB, a
// 32,768-row one 1 MB), and the per-object rows are a few hundred bytes. At
// 786,432 lanes that is 18.9 MB: 0.0056 ms at 3.35 TB/s, and a PyTorch copy
// of the same bytes takes about 0.0065 ms on an H100. About 150 integer and
// fp32 operations a lane, 0.0018 ms at the fp32 rate; the twelve IEEE
// divisions by 255 that the kernel made before added about 120, and with
// them it ran at half its bound (PERF.md, section 6).
//
// Design. One thread a lane, 256 a CTA. The lane loads are issued first;
// the per-object rows are staged in dynamic shared memory behind them (16
// ints a row: tex_w, tex_h, the six footprint-region columns, the three
// tile_params columns, the textured flag and the flat colour; sized to the
// table, so a scene's few rows leave the occupancy alone) when the table
// has at most kMaxStaged rows, and read from global memory otherwise (the
// per-lane form the tests use, one row per lane). A row is three 16-byte
// shared loads. Then the address and one 16-byte quad load, which a lane
// on an untextured object skips (most of the cubes' lanes hit the
// untextured floor). Four and two lanes a thread, with 16- and 8-byte lane
// accesses, were no faster than one (PERF.md, section 6).
//
// Exactness. The address math is the JAX package's, in int32 with the same
// clamps; the atlas's footprint quads already hold the reference's clamped
// taps (models.scene._footprint_atlas), so no tap is re-derived. A channel
// is k / 255 rounded to float32 (the twin reads the same values from a
// table), computed as q = k * RN(1/255) corrected by one fma step: exact for
// all 256 k, at three operations where an IEEE division takes about ten.
// The four taps are weighted as _tex_kernel weights them, with -fmad=false
// so each product is rounded as in the plain PyTorch twin. With the colour
// arguments a lane whose object is untextured writes its object's flat
// colour (its quad index is still written).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 11;         // TABLE_COLS
constexpr int kRow = 16;          // ints a staged row (four int4)
constexpr int kMaxStaged = 1024;  // table rows staged in shared memory (at most 64 KB)

struct ObjRow {
  int w, h, base, rx, ry, rw, rh, sm1, ss, r16;
  bool textured;
};

__device__ __forceinline__ int interleave8(int x) {  // texture_layout._interleave8
  x = (x | (x << 4)) & 0x0F0F;
  x = (x | (x << 2)) & 0x3333;
  x = (x | (x << 1)) & 0x5555;
  return x;
}

__device__ __forceinline__ int clip(int x, int lo, int hi) { return min(max(x, lo), hi); }

// RN((texel >> shift & 0xFF) / 255): q = k * RN(1/255), then
// q + (k - q * 255) * RN(1/255) with both steps fused; checked against
// float32 k / 255 for every k (tests/test_torch_texture.py).
__device__ __forceinline__ float channel(int texel, int shift) {
  constexpr float kInv255 = 1.0f / 255.0f;
  const float k = static_cast<float>((texel >> shift) & 0xFF);
  const float q = __fmul_rn(k, kInv255);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, k), kInv255, q);
}

// A lane's object row: staged (kRow ints) or from the global table.
template <bool kStaged, bool kSelect>
__device__ __forceinline__ ObjRow load_row(const int4* s_rows, const int* __restrict__ table,
                                           const unsigned char* __restrict__ textured, int o) {
  ObjRow r;
  if (kStaged) {
    const int4* p = s_rows + o * (kRow / 4);
    const int4 a = p[0], b = p[1], c = p[2];
    r.w = a.x; r.h = a.y; r.base = a.z; r.rx = a.w;
    r.ry = b.x; r.rw = b.z; r.rh = b.w;
    r.sm1 = c.x; r.ss = c.y; r.r16 = c.z;
    r.textured = !kSelect || c.w != 0;
  } else {
    const int* c = table + static_cast<size_t>(o) * kCols;
    r.w = c[0]; r.h = c[1]; r.base = c[2]; r.rx = c[3]; r.ry = c[4];
    r.rw = c[6]; r.rh = c[7]; r.sm1 = c[8]; r.ss = c[9]; r.r16 = c[10];
    r.textured = !kSelect || textured[o] != 0;
  }
  return r;
}

// Channel ch of an object's flat colour, staged or from the global table.
template <bool kStaged>
__device__ __forceinline__ float flat_color(const int4* s_rows, const float* __restrict__ color,
                                            int o, int ch) {
  if (!kStaged) return color[3 * o + ch];
  return __int_as_float(reinterpret_cast<const int*>(s_rows)[o * kRow + kCols + 1 + ch]);
}

// _address_lanes and tile_slot_fast: the footprint quad (2 * row + hi_half)
// of a lane, and its bilinear ratios.
__device__ __forceinline__ int quad_index(const ObjRow& c, float uu, float vv, int rq,
                                          float* u_ratio, float* v_ratio) {
  const float u = static_cast<float>(c.w) * uu;
  const float v = static_cast<float>(c.h) * (1.0f - vv);
  const int x = min(static_cast<int>(floorf(u)), c.w - 1);
  const int y = min(static_cast<int>(floorf(v)), c.h - 1);
  *u_ratio = u - static_cast<float>(x);
  *v_ratio = v - static_cast<float>(y);
  const int x0 = clip(x, 0, c.w - 1);
  const int y0 = clip(y, 0, c.h - 1);
  const int lx = clip(x0 - c.rx, 0, max(c.rw - 1, 0));
  const int ly = clip(y0 - c.ry, 0, max(c.rh - 1, 0));
  const int tx = lx >> 4, ty = ly >> 4;
  const int m = interleave8(tx & c.sm1) | (interleave8(ty & c.sm1) << 1);
  const int extra = ((tx * c.r16) >> 16) | ((ty * c.r16) >> 16);
  const int slot = (extra * c.ss + m) * 256 + (ly & 15) * 16 + (lx & 15);
  return clip((c.base + slot) * 4, 0, rq * 8 - 4) >> 2;
}

// The reference's weighting of the four taps (taps in reference order).
__device__ __forceinline__ float mix(int4 q, int shift, float u_ratio, float v_ratio) {
  const float u_opp = 1.0f - u_ratio;
  const float v_opp = 1.0f - v_ratio;
  const float row1 = channel(q.x, shift) * u_opp + channel(q.y, shift) * u_ratio;
  const float row2 = channel(q.z, shift) * u_ratio + channel(q.w, shift) * u_opp;
  return row1 * v_opp + row2 * v_ratio;
}

template <bool kStaged, bool kSelect>
__global__ void __launch_bounds__(kThreads)
footprint_kernel(const int4* __restrict__ quads, int rq, const int* __restrict__ table,
                 int n_table, const float* __restrict__ color,
                 const unsigned char* __restrict__ textured, const int* __restrict__ obj,
                 const float* __restrict__ u_row, const float* __restrict__ v_row, int n,
                 float* __restrict__ rgb, int* __restrict__ quad_out) {
  extern __shared__ int4 s_rows[];  // n_table rows of kRow ints when staged, else unused
  const int lane = blockIdx.x * kThreads + threadIdx.x;

  // The lane loads first: they do not wait for the table.
  int o = 0;
  float uu = 0.0f, vv = 0.0f;
  if (lane < n) {
    o = obj[lane];
    uu = u_row[lane];
    vv = v_row[lane];
  }
  if (kStaged) {
    int* s = reinterpret_cast<int*>(s_rows);
    for (int e = threadIdx.x; e < n_table * kRow; e += kThreads) {
      const int r = e / kRow, col = e % kRow;
      int x = 0;
      if (col < kCols) {
        x = table[r * kCols + col];
      } else if (col == kCols) {
        x = kSelect ? static_cast<int>(textured[r] != 0) : 1;
      } else if (kSelect && col < kCols + 4) {
        x = __float_as_int(color[3 * r + col - kCols - 1]);
      }
      s[e] = x;
    }
    __syncthreads();
  }
  if (lane >= n) return;

  const ObjRow c = load_row<kStaged, kSelect>(s_rows, table, textured, o);
  float ur, vr;
  const int qi = quad_index(c, uu, vv, rq, &ur, &vr);
  // One 16-byte load, none on an untextured object: the lane's footprint quad.
  if (c.textured) {
    const int4 q = __ldg(quads + qi);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[static_cast<size_t>(ch) * n + lane] = mix(q, 8 * ch, ur, vr);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      rgb[static_cast<size_t>(ch) * n + lane] = flat_color<kStaged>(s_rows, color, o, ch);
    }
  }
  if (quad_out != nullptr) quad_out[lane] = qi;
}

template <bool kStaged, bool kSelect>
int launch_fetch(const int4* quads, int rq, const int* table, int n_table, const float* color,
                 const unsigned char* textured, const int* obj, const float* u,
                 const float* v, int n, float* rgb, int* quad_out, cudaStream_t s) {
  const auto kernel = footprint_kernel<kStaged, kSelect>;
  const size_t smem = kStaged ? static_cast<size_t>(n_table) * kRow * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      quads, rq, table, n_table, color, textured, obj, u, v, n, rgb, quad_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// color (n_table, 3) f32 and textured (n_table,) bool select each lane's
// flat colour where its object is untextured; both null: the texel on every
// lane. u and v are the two rows of the lanes' uv.
extern "C" int rpt_footprint_sample(const void* quads, int rq, const void* table, int n_table,
                                    const void* color, const void* textured, const void* obj,
                                    const void* u, const void* v, int n, void* rgb,
                                    void* quad_out, void* stream) {
  if (n == 0) return 0;
  const auto* q = static_cast<const int4*>(quads);
  const auto* tab = static_cast<const int*>(table);
  const auto* col = static_cast<const float*>(color);
  const auto* tex = static_cast<const unsigned char*>(textured);
  const auto* ob = static_cast<const int*>(obj);
  const auto* ur = static_cast<const float*>(u);
  const auto* vr = static_cast<const float*>(v);
  auto* out = static_cast<float*>(rgb);
  auto* qo = static_cast<int*>(quad_out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool staged = n_table <= kMaxStaged;
  if (color != nullptr) {
    return staged ? launch_fetch<true, true>(q, rq, tab, n_table, col, tex, ob, ur, vr, n, out,
                                             qo, s)
                  : launch_fetch<false, true>(q, rq, tab, n_table, col, tex, ob, ur, vr, n,
                                              out, qo, s);
  }
  return staged ? launch_fetch<true, false>(q, rq, tab, n_table, col, tex, ob, ur, vr, n, out,
                                            qo, s)
                : launch_fetch<false, false>(q, rq, tab, n_table, col, tex, ob, ur, vr, n, out,
                                             qo, s);
}
