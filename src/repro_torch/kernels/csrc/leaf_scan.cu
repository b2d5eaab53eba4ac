// The ScaNN leaf-scan kernels, in two variants.
//
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
//
// leaf_scan: the legacy per-query leaf scan, every query against its own
// opened leaves.
//
// Replaces the Pallas kernel `_leaf_scan_kernel` of
// src/repro/kernels/leaf_scan.py (called through `leaf_scan_pallas`, one
// query, its nl opened tiles).  For every query q, every slot j of its
// (Q, nl) block of opened leaf ids and every row c of that leaf it returns
// ||q||^2 + ||x||^2 - 2 q.x with ||x||^2 summed in the kernel from the
// dequantized row (or -q.x for the inner product; every other metric is
// scored as L2, as the reference's kernel and oracle do), and +inf where
// the row is -1 padding or fails the query's bitmap.  Output (Q, nl, C).
//
// What bounds it on an H100: every (query, leaf) pair re-reads its C x d
// int8 tile, which is what the per-query path is (1,000 queries x 40
// leaves x 1,416 x 128 bytes = 7.3 GB at the SIFT1M shape), but the
// distinct tiles are at most the index (0.36 GB) and a tile is re-read
// from L2 while it stays there.  The work is 6 FP32 flops per tile byte
// (dequantize, x.q, x.x), so the least time is set by the FP32 rate, with
// the (Q, nl, C) float output second.
//
// What the design does about it: the whole batch is one launch over the
// (Q, nl) leaf-id block and the kernel reads each tile by id from the
// (L, C, d) table, so the (Q, nl, C, d) gather the vmapped reference
// implies is never built.  One block per (query, leaf slot) stages the
// query, scale and mean in shared memory once and sums ||q||^2 there; one
// warp per row reads the row with coalesced loads (a char4 a lane: a
// d = 128 row is one 128-byte transaction), dequantizes with fmaf,
// accumulates x.q and x.x, reduces with shuffles, and lane 0 probes
// bitmaps[q, id >> 5].  Tails of d (not a multiple of 4) and of C are
// masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeafWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void leaf_scan_kernel(
    const float* __restrict__ queries, const int* __restrict__ leaf_ids,
    const signed char* __restrict__ tiles, const int* __restrict__ rowids,
    const float* __restrict__ scale, const float* __restrict__ mean,
    const int* __restrict__ bitmaps, float* __restrict__ out, int nl, int L,
    int C, int d, int W, int metric, int vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int dpad = (d + 3) & ~3;
  float* ss = qs + dpad;
  float* ms = ss + dpad;
  __shared__ float qn_s;
  const int j = blockIdx.x, qi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    qs[i] = queries[(size_t)qi * d + i];
    ss[i] = scale[i];
    ms[i] = mean[i];
  }
  __syncthreads();
  if (warp == 0) {
    float qq = 0.f;
    for (int i = lane; i < d; i += 32) qq += qs[i] * qs[i];
    qq = warp_sum(qq);
    if (lane == 0) qn_s = qq;
  }
  __syncthreads();
  const float qn = qn_s;
  const int leaf = leaf_ids[(size_t)qi * nl + j];
  float* orow = out + ((size_t)qi * nl + j) * C;
  for (int c = warp; c < C; c += kLeafWarps) {
    const int rid = (leaf >= 0 && leaf < L) ? __ldg(rowids + (size_t)leaf * C + c)
                                            : -1;
    if (rid < 0) {
      if (lane == 0) orow[c] = INFINITY;
      continue;
    }
    const signed char* t = tiles + ((size_t)leaf * C + c) * d;
    float ip = 0.f, xx = 0.f;
    if (vec4) {
      const char4* t4 = reinterpret_cast<const char4*>(t);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const float4* s4 = reinterpret_cast<const float4*>(ss);
      const float4* m4 = reinterpret_cast<const float4*>(ms);
      for (int i = lane; i < (d >> 2); i += 32) {
        const char4 a = __ldg(t4 + i);
        const float4 b = q4[i], s = s4[i], m = m4[i];
        const float x0 = fmaf((float)a.x, s.x, m.x);
        const float x1 = fmaf((float)a.y, s.y, m.y);
        const float x2 = fmaf((float)a.z, s.z, m.z);
        const float x3 = fmaf((float)a.w, s.w, m.w);
        ip += x0 * b.x + x1 * b.y + x2 * b.z + x3 * b.w;
        xx += x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3;
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float x = fmaf((float)__ldg(t + i), ss[i], ms[i]);
        ip += x * qs[i];
        xx += x * x;
      }
    }
    ip = warp_sum(ip);
    xx = warp_sum(xx);
    if (lane == 0) {
      const unsigned word =
          (unsigned)__ldg(bitmaps + (size_t)qi * W + (rid >> 5));
      const bool ok = (word >> (rid & 31)) & 1u;
      orow[c] = ok ? (metric == 1 ? -ip : qn + xx - 2.f * ip) : INFINITY;
    }
  }
}

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

extern "C" int leaf_scan_f32(const void* queries, const void* leaf_ids,
                             const void* tiles, const void* rowids,
                             const void* scale, const void* mean,
                             const void* bitmaps, void* out, int Q, int nl,
                             int L, int C, int d, int W, int metric, int vec4,
                             void* stream) {
  if (Q == 0 || nl == 0 || C == 0) return 0;
  dim3 grid(nl, Q);
  const size_t smem = (size_t)3 * ((d + 3) / 4) * sizeof(float4);
  leaf_scan_kernel<<<grid, kLeafWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)leaf_ids, (const signed char*)tiles,
      (const int*)rowids, (const float*)scale, (const float*)mean,
      (const int*)bitmaps, (float*)out, nl, L, C, d, W, metric, vec4);
  return (int)cudaGetLastError();
}

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
