// distance_matrix: (Q, N) L2 or inner-product distances between two row sets.
//
// Replaces the Pallas kernel `_dist_kernel` of src/repro/kernels/distance.py
// (called through `distance_matrix_pallas`): the ScaNN centroid levels score
// every query of a block against the branch and leaf centroids with it.
// L2 is ||q||^2 + ||x||^2 - 2 q.x with both norms reduced in the kernel from
// the tiles it already holds, so no second pass over either input is made.
//
// What bounds it on an H100: at the search path's shapes (Q = a query
// block of 64, N = 44 branch or 2000 leaf centroids, d = 128) the whole
// problem is well under a millisecond of memory traffic and of FP32 work;
// a launch of a few microseconds and the output write bound it, not the
// multiply-adds.
//
// What the design does about it: a classic shared-memory tiled product in
// FP32 FMA (no TF32, so the distances keep full single precision).  A block
// of 16 x 16 threads owns a 64 x 64 output tile; each thread accumulates a
// 4 x 4 micro-tile over a K loop in steps of 16, and the same loop sums the
// squares of the query and row entries it reads, which gives both norms for
// free.  Partial tiles at the ragged edges are zero-filled on load and
// masked on store.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;

__global__ void distance_matrix_kernel(const float* __restrict__ q,
                                       const float* __restrict__ x,
                                       float* __restrict__ out, int Q, int N,
                                       int d, int metric) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN] = {};
  float qn[TM] = {}, xn[TN] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    // 256 threads load 64 x 16 entries of each input, 4 each
    for (int e = tid; e < BM * BK; e += 256) {
      const int r = e / BK, k = e % BK;
      const int gr = m0 + r, gk = k0 + k;
      As[k][r] = (gr < Q && gk < d) ? q[(size_t)gr * d + gk] : 0.f;
      const int gn = n0 + r;
      Bs[k][r] = (gn < N && gk < d) ? x[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qn[i] += a[i] * a[i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) xn[j] += b[j] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty * TM + i;
    if (gr >= Q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      out[(size_t)gr * N + gn] =
          metric == 1 ? -acc[i][j] : qn[i] + xn[j] - 2.f * acc[i][j];
    }
  }
}

}  // namespace

extern "C" int distance_matrix_f32(const void* q, const void* x, void* out,
                                   int Q, int N, int d, int metric,
                                   void* stream) {
  if (Q == 0 || N == 0) return 0;
  dim3 block(16, 16);
  dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  distance_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)x, (float*)out, Q, N, d, metric);
  return (int)cudaGetLastError();
}
