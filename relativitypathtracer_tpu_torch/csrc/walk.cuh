// The cluster walk's building blocks, shared by the mesh walks of
// csrc/mesh_kernels.cu (K5, K6, K11, K12) and csrc/mesh_batch.cu (K9, K10):
// the mapping's sizes, the flat live list and its cursor, the cluster's
// split barrier and bound pushes, and the triangle row loads. Each source
// that includes it gets its own copy (internal linkage).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kShRow = 10;   // shared triangle row: det(3) u(3) v(3) ct
constexpr int kGenRow = 20;  // general triangle row: det(3) u(6) v(6) t(4) pad
constexpr int kAttr = 15;

// Both walks: a cluster of kCluster CTAs per 1024-ray block, each of kWarps
// warps; at entry each thread reads kLanes lanes of the block, and each CTA
// keeps at most kSlots of its rays.
constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = rpt::kNB / kThreads;
constexpr int kSlots = rpt::kNB / kCluster;
constexpr int kBatch = 4;  // rays a warp tests at once

inline cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

// K5/K6 lists: order (B, C) chunk ids, minds (B, C) floors by chunk id,
// counts (B,) live chunks. K9/K10 walk the same lists over a pool of any
// size, so shared memory holds a bounded head of a block's list and the
// cursor reads the entries past it from global memory.
struct FlatList {
  static constexpr bool kMaskTail = false;  // every chunk holds kTC triangles to test
  // Entries of a block's list staged in shared memory: every list of a mesh
  // below the large tier's 768 chunks (K5/K6), and the pools of a few such
  // meshes (K9/K10), fits whole.
  static constexpr int kStageMax = 1024;
  const int* order;
  const float* minds;
  const int* counts;
  int n_chunks;

  __host__ __device__ int n_staged() const {
    return n_chunks < kStageMax ? n_chunks : kStageMax;
  }

  // The copy of the head of block b's list in shared memory: its first
  // n_staged() live chunk ids in walk order, their floors, then the global
  // rows of its ids and floors (two pointers) for the entries past them
  // (stage_words() 32-bit words).
  size_t stage_words() const { return 2 * static_cast<size_t>(n_staged()) + 4; }

  __device__ void stage(int b, int* s) const {
    const size_t row = static_cast<size_t>(b) * n_chunks;
    const int n_st = n_staged();
    float* fl = reinterpret_cast<float*>(s + n_st);
    const int n = counts[b] < n_st ? counts[b] : n_st;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int c = order[row + e];
      s[e] = c;
      fl[e] = minds[row + c];
    }
    if (threadIdx.x == 0) {
      const void** rows = reinterpret_cast<const void**>(s + 2 * n_st);
      rows[0] = order + row;
      rows[1] = minds + row;
    }
  }

  // Yields the next chunk of the list and its floor, from the staged head
  // or past it from global memory (every thread reads the same entry); the
  // caller stops on the floor.
  struct Cursor {
    const int* s;  // the staged copy
    int n_staged;
    int n_live;
    int j;

    __device__ bool advance(int* k, float* floor_out) {
      if (j >= n_live) return false;
      if (j < n_staged) {
        *k = s[j];
        *floor_out = reinterpret_cast<const float*>(s + n_staged)[j];
      } else {
        const void* const* rows = reinterpret_cast<const void* const*>(s + 2 * n_staged);
        const int c = static_cast<const int*>(rows[0])[j];
        *k = c;
        *floor_out = static_cast<const float*>(rows[1])[c];
      }
      ++j;
      return true;
    }
  };

  __device__ Cursor cursor(int b, const int* s) const {
    return Cursor{s, n_staged(), counts[b], 0};
  }
};

// Max over the cluster of the warp values each CTA left in its own `half`
// (the shadow walk's first bound): each lane reads kCluster * kWarps / 32 of
// them from the CTAs that hold them, then a warp reduction, so every thread
// of the cluster gets the same value (the values are >= 0).
__device__ __forceinline__ float cluster_max(cooperative_groups::cluster_group& cluster,
                                             float* half, int lane) {
  float m = 0.0f;
#pragma unroll
  for (int e = lane; e < kCluster * kWarps; e += 32) {
    m = fmaxf(m, cluster.map_shared_rank(half, e / kWarps)[e % kWarps]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// Max of the kCluster * kWarps warp values pushed into this CTA's `all`
// (the walks' per-chunk bound): local reads and a warp reduction.
__device__ __forceinline__ float pushed_max(const float* all, int lane) {
  float m = 0.0f;
#pragma unroll
  for (int e = lane; e < kCluster * kWarps; e += 32) m = fmaxf(m, all[e]);
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

// Warp value `w` into slot `slot` of `all` in every CTA of the cluster: lane
// r stores into CTA r (remote shared stores, which do not wait).
__device__ __forceinline__ void push_to_cluster(cooperative_groups::cluster_group& cluster,
                                                float* all, int slot, float w, int lane) {
  if (lane < kCluster) cluster.map_shared_rank(all, lane)[slot] = w;
}

// A ray's running best: distance, barycentrics and triangle id (-1: none).
struct __align__(16) Best {
  float t, u, v;
  int tri;
};

// Lane `lane`'s shared triangle row of chunk k: five 8-byte loads.
__device__ __forceinline__ void load_shared_row(const float2* __restrict__ rows2, int k,
                                                int lane, float* c) {
  const float2* src = rows2 + (static_cast<size_t>(k) * rpt::kTC + lane) * (kShRow / 2);
#pragma unroll
  for (int i = 0; i < kShRow / 2; ++i) {
    const float2 q = src[i];
    c[2 * i] = q.x;
    c[2 * i + 1] = q.y;
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

constexpr int kMaxDevices = 64;  // device ordinals the opt-in keeps

// The dynamic shared memory a kernel was opted in to on each device ordinal,
// -1 until its first launch there: the opt-in is a property of the kernel on
// one device.
struct SharedOptIn {
  int bytes[kMaxDevices];
  SharedOptIn() {
    for (int& b : bytes) b = -1;
  }
};

// Opts `kernel` in to the most dynamic shared memory the current device
// allows (static and dynamic together, past the 48 KB default) on its first
// call on that device; *max_bytes gets the dynamic bytes allowed there. A
// device ordinal at or past kMaxDevices is an error.
template <class Kernel>
cudaError_t opt_in_shared(Kernel* kernel, SharedOptIn& opt, int* max_bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opt.bytes[dev] >= 0) {
    *max_bytes = opt.bytes[dev];
    return cudaSuccess;
  }
  cudaFuncAttributes attr{};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  }
  if (err == cudaSuccess) {
    opt.bytes[dev] = dynamic;
    *max_bytes = dynamic;
  }
  return err;
}

}  // namespace
