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
// K5/K6 (csrc/mesh_kernels.cu): 32 ray/triangle tests per live chunk and
// ray, plus one multiply by s.
//
// Design: the walk of K5/K6 (one CUDA block per 1024-ray block, 256 threads
// x 4 rays in registers, each chunk staged in shared memory, a block
// max-reduce for the bound). The TPU fills (8|16) x O rows of per-object rays
// in VMEM at block start; 4 rays x O objects do not fit in registers, and for
// K10 at O = 8 not in shared memory either (11 floats x 1,024 x 8 x 4 B).
// So a thread re-derives its rays' object-frame values from the (O, 40)
// transform table, held in shared memory, whenever the walked chunk's object
// differs from the last one's: about 50 operations against the chunk's 32
// triangle tests, and the pool is object-major, so a block switches objects
// a few times per walk. The derivation runs the JAX package's operations in
// its order (mat_rows left to right, then IEEE sqrt and division), so a
// thread's rays are those the plain twin precomputes per object, to the bit.
// The winner's attributes are one fp32 row read at the end (the TPU selects
// them with hi/lo bf16 one-hot products); the chunk pairing is not copied.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = rpt::kNB / kThreads;
constexpr int kShRow = 10;
constexpr int kGenRow = 20;
constexpr int kAttr = 15;

// The per-object transform table (mesh_batch.MAT_COLS columns).
constexpr int kMatCols = 40;
constexpr int kA = 0;    // 12: fused dir/origin transform inv_m[:3,:3] @ L[1:4,:]
constexpr int kB = 12;   // 3: inv_m translation
constexpr int kMR = 18;  // 9: m[:3,:3] (object -> rest scale for s)
constexpr int kL3 = 27;  // 12: L[1:4,:] (|d3| for s)

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

__global__ void __launch_bounds__(kThreads)
batched_shared_walk_kernel(const int* __restrict__ order, const float* __restrict__ minds,
                           const int* __restrict__ counts, const int* __restrict__ cobj,
                           const float* __restrict__ boxes, const float* __restrict__ mats,
                           const float* __restrict__ tri, const float* __restrict__ attrs,
                           const float* __restrict__ dir4, int n, int n_chunks, int n_obj,
                           float* __restrict__ t_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, int* __restrict__ tri_out,
                           int* __restrict__ obj_out, float* __restrict__ attr_out) {
  extern __shared__ float s_tab[];  // mats (O, 40), then boxes (O, 9)
  __shared__ float s_tri[rpt::kTC * kShRow];
  __shared__ float s_red[kThreads / 32];
  float* s_mats = s_tab;
  float* s_box = s_tab + n_obj * kMatCols;
  for (int e = threadIdx.x; e < n_obj * kMatCols; e += kThreads) s_mats[e] = mats[e];
  for (int e = threadIdx.x; e < n_obj * 9; e += kThreads) s_box[e] = boxes[e];
  __syncthreads();
  const int b = blockIdx.x;

  float d4[kRays][4], dh[kRays][3], s[kRays], bound[kRays];
  float bt[kRays], bu[kRays], bv[kRays];
  int btri[kRays], bobj[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int lane = b * rpt::kNB + r * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) d4[r][c] = dir4[static_cast<size_t>(c) * n + lane];
    bound[r] = 0.0f;
    bt[r] = rpt::kInf;
    bu[r] = 0.0f;
    bv[r] = 0.0f;
    btri[r] = -1;
    bobj[r] = -1;
  }
  // Per-lane bound in shared units: the farthest exit from any object's
  // chunk-union box, scaled by that object's s.
  for (int g = 0; g < n_obj; ++g) {
    const float* bx = s_box + g * 9;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      object_dir(s_mats + g * kMatCols, d4[r], dh[r], &s[r]);
      bound[r] = fmaxf(bound[r], rpt::box_bound(bx, bx + 3, bx[6], bx[7], bx[8], dh[r][0],
                                                dh[r][1], dh[r][2]) * s[r]);
    }
  }
  float local = 0.0f;
#pragma unroll
  for (int r = 0; r < kRays; ++r) local = fmaxf(local, bound[r]);
  float mb = rpt::block_max<kThreads>(local, s_red);

  const int n_live = counts[b];
  const int* ord = order + static_cast<size_t>(b) * n_chunks;
  const float* md = minds + static_cast<size_t>(b) * n_chunks;
  int cur = n_obj - 1;  // the object whose rays dh/s hold now
  for (int j = 0; j < n_live; ++j) {
    const int k = ord[j];
    if (!(md[k] < mb)) break;
    const int g = cobj[k];
    if (g != cur) {
      cur = g;
#pragma unroll
      for (int r = 0; r < kRays; ++r) object_dir(s_mats + g * kMatCols, d4[r], dh[r], &s[r]);
    }
    __syncthreads();
    const float* src = tri + static_cast<size_t>(k) * rpt::kTC * kShRow;
    for (int e = threadIdx.x; e < rpt::kTC * kShRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    local = 0.0f;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      float dmin = rpt::kInf, umin = 0.0f, vmin = 0.0f;
      int imin = 0;
      for (int i = 0; i < rpt::kTC; ++i) {
        float u, v, dist;
        const bool ok = rpt::shared_tri_test(s_tri + i * kShRow, dh[r][0], dh[r][1], dh[r][2],
                                             &u, &v, &dist);
        const float tsh = dist * s[r];
        if (ok && tsh < dmin) {
          dmin = tsh;
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
        bobj[r] = g;
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
    obj_out[lane] = bobj[r];
    const float* row = attrs + static_cast<size_t>(btri[r] < 0 ? 0 : btri[r]) * kAttr;
#pragma unroll
    for (int a = 0; a < kAttr; ++a) {
      attr_out[static_cast<size_t>(a) * n + lane] = btri[r] < 0 ? 0.0f : row[a];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
batched_general_walk_kernel(const int* __restrict__ order, const float* __restrict__ minds,
                            const int* __restrict__ counts, const int* __restrict__ cobj,
                            const float* __restrict__ boxes, const float* __restrict__ mats,
                            const float* __restrict__ rows, const float* __restrict__ origins4,
                            const float* __restrict__ dir4, const float* __restrict__ tmax_in,
                            int n, int n_chunks, int n_obj, float* __restrict__ t_out) {
  extern __shared__ float s_tab[];  // mats (O, 40), then boxes (O, 6)
  __shared__ float s_tri[rpt::kTC * kGenRow];
  __shared__ float s_red[kThreads / 32];
  float* s_mats = s_tab;
  float* s_box = s_tab + n_obj * kMatCols;
  for (int e = threadIdx.x; e < n_obj * kMatCols; e += kThreads) s_mats[e] = mats[e];
  for (int e = threadIdx.x; e < n_obj * 6; e += kThreads) s_box[e] = boxes[e];
  __syncthreads();
  const int b = blockIdx.x;

  float o4[kRays][4], d4[kRays][4], x[kRays][10], s[kRays];
  float tmax[kRays], teff[kRays], bt[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int lane = b * rpt::kNB + q * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o4[q][c] = origins4[static_cast<size_t>(c) * n + lane];
      d4[q][c] = dir4[static_cast<size_t>(c) * n + lane];
    }
    tmax[q] = tmax_in[lane];
    teff[q] = 0.0f;
    bt[q] = rpt::kInf;
  }
  // Walk bound min(tmax, farthest box exit in shared units). A disabled
  // object (the light) carries the table's stand-in box [1 1 1 0 0 0].
  for (int g = 0; g < n_obj; ++g) {
    const float* bx = s_box + g * 6;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      object_ray(s_mats + g * kMatCols, o4[q], d4[q], x[q], &s[q]);
      teff[q] = fmaxf(teff[q], rpt::box_bound(bx, bx + 3, x[q][6], x[q][7], x[q][8], x[q][0],
                                              x[q][1], x[q][2]) * s[q]);
    }
  }
  float local = 0.0f;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    teff[q] = fminf(tmax[q], teff[q]);
    local = fmaxf(local, teff[q]);
  }
  float mb = rpt::block_max<kThreads>(local, s_red);

  const int n_live = counts[b];
  const int* ord = order + static_cast<size_t>(b) * n_chunks;
  const float* md = minds + static_cast<size_t>(b) * n_chunks;
  int cur = n_obj - 1;
  for (int j = 0; j < n_live; ++j) {
    const int k = ord[j];
    if (!(md[k] < mb)) break;
    const int g = cobj[k];
    if (g != cur) {
      cur = g;
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        object_ray(s_mats + g * kMatCols, o4[q], d4[q], x[q], &s[q]);
      }
    }
    __syncthreads();
    const float* src = rows + static_cast<size_t>(k) * rpt::kTC * kGenRow;
    for (int e = threadIdx.x; e < rpt::kTC * kGenRow; e += kThreads) s_tri[e] = src[e];
    __syncthreads();
    local = 0.0f;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float cmin = rpt::kInf;
      for (int i = 0; i < rpt::kTC; ++i) {
        float dist;
        if (rpt::general_tri_test(s_tri + i * kGenRow, x[q], &dist)) {
          cmin = fminf(cmin, dist * s[q]);
        }
      }
      bt[q] = fminf(bt[q], cmin);
      // Occlusion retirement: any hit below tmax (both in shared units)
      // proves the lane shadowed.
      local = fmaxf(local, bt[q] < tmax[q] ? 0.0f : fminf(bt[q], teff[q]));
    }
    mb = rpt::block_max<kThreads>(local, s_red);
  }

#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int lane = b * rpt::kNB + q * kThreads + threadIdx.x;
    t_out[lane] = fminf(bt[q], tmax[q]);
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int rpt_batched_shared_walk(const void* order, const void* minds, const void* counts,
                                       const void* cobj, const void* boxes, const void* mats,
                                       const void* tri, const void* attrs, const void* dir4,
                                       int n, int n_chunks, int n_obj, void* t, void* u,
                                       void* v, void* tri_out, void* obj_out, void* attr,
                                       void* stream) {
  const size_t smem = static_cast<size_t>(n_obj) * (kMatCols + 9) * sizeof(float);
  const cudaError_t err = allow_smem(batched_shared_walk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_shared_walk_kernel<<<n / rpt::kNB, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(minds),
      static_cast<const int*>(counts), static_cast<const int*>(cobj),
      static_cast<const float*>(boxes), static_cast<const float*>(mats),
      static_cast<const float*>(tri), static_cast<const float*>(attrs),
      static_cast<const float*>(dir4), n, n_chunks, n_obj, static_cast<float*>(t),
      static_cast<float*>(u), static_cast<float*>(v), static_cast<int*>(tri_out),
      static_cast<int*>(obj_out), static_cast<float*>(attr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_batched_general_walk(const void* order, const void* minds,
                                        const void* counts, const void* cobj,
                                        const void* boxes, const void* mats, const void* rows,
                                        const void* origins4, const void* dir4,
                                        const void* tmax, int n, int n_chunks, int n_obj,
                                        void* t, void* stream) {
  const size_t smem = static_cast<size_t>(n_obj) * (kMatCols + 6) * sizeof(float);
  const cudaError_t err = allow_smem(batched_general_walk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_general_walk_kernel<<<n / rpt::kNB, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(minds),
      static_cast<const int*>(counts), static_cast<const int*>(cobj),
      static_cast<const float*>(boxes), static_cast<const float*>(mats),
      static_cast<const float*>(rows), static_cast<const float*>(origins4),
      static_cast<const float*>(dir4), static_cast<const float*>(tmax), n, n_chunks, n_obj,
      static_cast<float*>(t));
  return static_cast<int>(cudaGetLastError());
}
