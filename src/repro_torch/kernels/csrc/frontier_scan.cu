// frontier_scan: one graph superstep's candidate scoring + filter probe.
//
// Replaces the Pallas kernel `_frontier_scan_kernel` of
// src/repro/kernels/frontier_scan.py (called through `frontier_scan_pallas`).
// For every (query, candidate id) it returns the L2 distance
// ||q||^2 + ||x||^2 - 2 q.x (precomputed ||x||^2) or the negated inner
// product, +inf where the id is -1 padding, and the bit of the query's
// packed filter bitmap for that id.
//
// What bounds it on an H100: it is a gather-GEMV.  Each candidate row
// (4d bytes) is read once, with its norm, id and bitmap word, and nothing
// is reused across candidates, so it moves about Q*C*(4d + 12) bytes for
// 2*Q*C*d flops: memory bound, far below the FP32 ridge point.
//
// What the design does about it: the TPU kernel received an already
// gathered (Q, C, d) block; here the kernel gathers each row by id from
// the (n, d) store itself, so that block is never written to or read back
// from device memory.  One warp scores one (query, candidate): its 32 lanes
// read the row with coalesced 16-byte loads, multiply against the query
// held in shared memory, and reduce with warp shuffles.  Lane 0 completes
// the distance and probes the bitmap word.  A block of 8 warps shares one
// query, loaded into shared memory once.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void frontier_scan_kernel(const float* __restrict__ queries,
                                     const float* __restrict__ rows,
                                     const float* __restrict__ norms,
                                     const int* __restrict__ ids,
                                     const int* __restrict__ bitmaps,
                                     float* __restrict__ dist,
                                     unsigned char* __restrict__ pass,
                                     int C, int d, int W, int n, int metric,
                                     int vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int qi = blockIdx.y;
  const float* qrow = queries + (size_t)qi * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qrow[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;
  const size_t o = (size_t)qi * C + c;
  const int id = ids[o];
  if (id < 0 || id >= n) {
    if (lane == 0) {
      dist[o] = INFINITY;
      pass[o] = 0;
    }
    return;
  }
  const float* x = rows + (size_t)id * d;
  float ip = 0.f, qq = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int i = lane; i < (d >> 2); i += 32) {
      const float4 a = __ldg(x4 + i);
      const float4 b = q4[i];
      ip += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      qq += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float b = qs[i];
      ip += __ldg(x + i) * b;
      qq += b * b;
    }
  }
  ip = warp_sum(ip);
  qq = warp_sum(qq);
  if (lane == 0) {
    dist[o] = metric == 1 ? -ip : qq + __ldg(norms + id) - 2.f * ip;
    const unsigned word = (unsigned)__ldg(bitmaps + (size_t)qi * W + (id >> 5));
    pass[o] = (unsigned char)((word >> (id & 31)) & 1u);
  }
}

}  // namespace

extern "C" int frontier_scan_f32(const void* queries, const void* rows,
                                 const void* norms, const void* ids,
                                 const void* bitmaps, void* dist, void* pass,
                                 int Q, int C, int d, int W, int n,
                                 int metric, int vec4, void* stream) {
  if (Q == 0 || C == 0) return 0;
  dim3 grid((C + kWarps - 1) / kWarps, Q);
  const size_t smem = (size_t)((d + 3) / 4) * sizeof(float4);
  frontier_scan_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const float*)rows, (const float*)norms,
      (const int*)ids, (const int*)bitmaps, (float*)dist,
      (unsigned char*)pass, C, d, W, n, metric, vec4);
  return (int)cudaGetLastError();
}
