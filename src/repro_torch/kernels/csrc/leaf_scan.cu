// leaf_scan_batched: the ScaNN union leaf scan for a block of queries.
//
// Replaces the Pallas kernel `_leaf_scan_batched_kernel` of
// src/repro/kernels/leaf_scan.py (called through `leaf_scan_batched_pallas`).
// For every query q and every row c of every opened leaf tile u it returns
// ||q||^2 + ||x||^2 - 2 q.x (or -q.x for the inner product) with
// x = tile * scale + mean dequantized from int8, and +inf where the row is
// -1 padding or fails the query's packed filter bitmap.  Output (Q, U, C).
//
// What bounds it on an H100: each int8 tile is read once for the whole
// query block (U*C*d bytes) but the scores are written as Q*U*C floats:
// for d = 128 and a block of 64 queries that is 2 bytes of output per byte
// of tile, so the output dominates the bytes moved, and it grows with the
// block (the caller bounds it by tiling the batch, `scann_query_block`).
// The work is 2*Q*U*C*d FP32 flops, about 42 per byte moved at Q = 64 and
// d = 128, above the card's FP32 ridge point of about 20, so the least time
// is set by the FP32 FMA rate and the output traffic comes second.
//
// What the design does about it: one block owns one (leaf, 64-row tile,
// 64-query tile).  It dequantizes the int8 rows into shared memory K-slice
// by K-slice (each tile byte is read once per query tile), takes an FP32
// tiled product against the resident query slice (16 x 16 threads, a 4 x 4
// micro-tile each, no TF32), sums the query squares from the same slices,
// and in the epilogue completes the L2 distance with the precomputed row
// norms and probes one bitmap word per (query, row), writing +inf for rows
// that fail or are padding.  The dequantization rounds the product and the
// sum separately (no fused multiply-add), as the plain version does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;

__global__ void leaf_scan_batched_kernel(
    const float* __restrict__ queries, const signed char* __restrict__ tiles,
    const int* __restrict__ rowids, const float* __restrict__ scale,
    const float* __restrict__ mean, const int* __restrict__ bitmaps,
    const float* __restrict__ norms, float* __restrict__ out, int Q, int U,
    int C, int d, int W, int metric) {
  __shared__ float As[BK][BM];   // query slice, k-major
  __shared__ float Bs[BK][BN];   // dequantized row slice, k-major
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * BM, u = blockIdx.z;
  const signed char* tile = tiles + (size_t)u * C * d;

  float acc[TM][TN] = {};
  float qn[TM] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      const int r = e / BK, k = e % BK;
      const int gk = k0 + k;
      const int gq = m0 + r;
      As[k][r] = (gq < Q && gk < d) ? queries[(size_t)gq * d + gk] : 0.f;
      const int gc = c0 + r;
      float v = 0.f;
      if (gc < C && gk < d)
        v = __fadd_rn(__fmul_rn((float)tile[(size_t)gc * d + gk], scale[gk]),
                      mean[gk]);
      Bs[k][r] = v;
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
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = c0 + tx * TN + j;
    if (gc >= C) continue;
    const int rid = rowids[(size_t)u * C + gc];
    const float xn = metric == 1 ? 0.f : norms[(size_t)u * C + gc];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gq = m0 + ty * TM + i;
      if (gq >= Q) continue;
      float v = INFINITY;
      if (rid >= 0) {
        const unsigned word =
            (unsigned)bitmaps[(size_t)gq * W + (rid >> 5)];
        if ((word >> (rid & 31)) & 1u)
          v = metric == 1 ? -acc[i][j] : qn[i] + xn - 2.f * acc[i][j];
      }
      out[((size_t)gq * U + u) * C + gc] = v;
    }
  }
}

}  // namespace

extern "C" int leaf_scan_batched_f32(const void* queries, const void* tiles,
                                     const void* rowids, const void* scale,
                                     const void* mean, const void* bitmaps,
                                     const void* norms, void* out, int Q,
                                     int U, int C, int d, int W, int metric,
                                     void* stream) {
  if (Q == 0 || U == 0 || C == 0) return 0;
  dim3 block(16, 16);
  dim3 grid((C + BN - 1) / BN, (Q + BM - 1) / BM, U);
  leaf_scan_batched_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)queries, (const signed char*)tiles, (const int*)rowids,
      (const float*)scale, (const float*)mean, (const int*)bitmaps,
      (const float*)norms, (float*)out, Q, U, C, d, W, metric);
  return (int)cudaGetLastError();
}
