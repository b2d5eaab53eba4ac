// topk: the k smallest values of a 1-D float32 array, with their indices.
//
// Replaces the Pallas kernel `_topk_block_kernel` of
// src/repro/kernels/topk.py (called through `topk_pallas`) and the
// `lax.top_k` of its second stage.  One pass cuts the values into chunks and
// reduces each chunk to its k smallest by k masked-min extractions: each
// round takes the block's minimum by (value, position), ties to the lowest
// position, writes it out with its index (-1 when the value is +inf, the
// filtered / padded marker; -inf keeps its index) and sets it to +inf in
// shared memory.  Rounds past the chunk's end yield (+inf, -1), which pads
// k > n.  The wrapper runs passes over the survivors until one chunk is
// left; each pass keeps the (value, position) order of the one before, so
// the result is the reference's: the k smallest in value order, ties by
// position.  NaN is not ordered (callers pass none).
//
// What bounds it on an H100: one read of the n values (4n bytes) and
// k rounds of a block reduction per chunk; at the sizes it runs (n up to a
// few million, k <= 100) the values' bytes set the least time, and a real
// launch is dominated by its fixed cost and the k dependent rounds.
//
// What the design does about it: the TPU kernel's sequential grid over
// blocks becomes one block per chunk, all in parallel; the chunk lives in
// shared memory (values and source indices), so the k rounds never touch
// device memory; the round's argmin is a thread-local scan, a warp shuffle
// reduction and a reduction over the warps' winners.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool before(float v, int p, float bv, int bp) {
  return v < bv || (v == bv && p < bp);
}

__global__ void topk_chunk_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ idx, int m,
                                  int chunk, int k, float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  extern __shared__ float sm[];
  float* sv = sm;
  int* si = reinterpret_cast<int*>(sm + chunk);
  __shared__ float wv[kThreads / 32];
  __shared__ int wp[kThreads / 32];
  const int b = blockIdx.x;
  const long long base = (long long)b * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long long g = base + i;
    const bool in = g < m;
    sv[i] = in ? vals[g] : INFINITY;
    si[i] = in ? (idx != nullptr ? idx[g] : (int)g) : -1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < k; ++j) {
    float bv = INFINITY;
    int bp = INT_MAX;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const float v = sv[i];
      if (before(v, i, bv, bp)) {
        bv = v;
        bp = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int op = __shfl_down_sync(0xffffffffu, bp, off);
      if (before(ov, op, bv, bp)) {
        bv = ov;
        bp = op;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wp[warp] = bp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      bv = wv[0];
      bp = wp[0];
      for (int w = 1; w < kThreads / 32; ++w)
        if (before(wv[w], wp[w], bv, bp)) {
          bv = wv[w];
          bp = wp[w];
        }
      const size_t o = (size_t)b * k + j;
      out_v[o] = bv;
      out_i[o] = (bv == INFINITY || bp == INT_MAX) ? -1 : si[bp];
      if (bp != INT_MAX) sv[bp] = INFINITY;
    }
    __syncthreads();
  }
}

}  // namespace

// One pass: m values (with source indices `idx`, or their positions when
// idx is null) in chunks of `chunk` -> (ceil(m / chunk), k) survivors.
extern "C" int topk_chunk_f32(const void* vals, const void* idx, void* out_v,
                              void* out_i, int m, int chunk, int k,
                              void* stream) {
  if (m == 0 || k == 0) return 0;
  const int nb = (int)(((long long)m + chunk - 1) / chunk);
  const size_t smem = (size_t)chunk * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_chunk_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)idx, m, chunk, k, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
