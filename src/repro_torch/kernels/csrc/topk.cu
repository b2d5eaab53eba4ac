// topk: the k smallest values of a 1-D float32 array, with their indices.
//
// Replaces the Pallas kernel `_topk_block_kernel` of
// src/repro/kernels/topk.py (called through `topk_pallas`) and the
// `lax.top_k` of its second stage.  Contract: the k smallest in ascending
// order, ties to the lowest index; index -1 where the value is +inf (the
// filtered / padded marker) and for the slots past n; -inf keeps its index.
// NaN is not ordered (callers pass none).
//
// What bounds it on an H100: one read of the n values (4n bytes) and k
// (value, index) pairs out; at the sizes it runs (n up to a few million, k
// up to a few hundred) that is microseconds of memory time, so a launch is
// set by its fixed cost and by how many dependent steps (block barriers,
// launches) it takes.  The TPU-shaped design took k block-wide rounds per
// chunk and three launches at n = 56,640, k = 40.
//
// What the design does about it.  Each value becomes one 64-bit key: the
// float's bits made order-preserving as an unsigned integer (-0.0 first
// mapped to +0.0, so the two tie and the index decides) in the high word,
// the index in the low word.  Keys are unique, and "ties to the lowest
// index" is one integer compare.
// - Stage 1, one block per chunk of up to 8,192 values held in shared
//   memory: a radix select finds the chunk's k-th key by 8-bit digit
//   histograms (warp-aggregated shared-memory atomics), high digits first,
//   stopping at the first digit whose bin is taken whole (for distinct
//   values that is within the value's bits); the keys at or below it are
//   compacted out, unordered.
// - Stage 2, one block over the chunks' survivors (a second launch, only
//   when there is more than one chunk): the same select, then each of the
//   k keys finds its rank by counting the smaller ones, and the values are
//   read back from the input by index (so -0.0 comes out as -0.0).
// At most two launches and no host loop; the wrapper's one allocation
// holds the outputs and the survivors.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 512;
// stage 2 copies at most this many survivors into shared memory; more are
// read from device memory in place
constexpr int kStage2Cap = 8192;

__device__ __forceinline__ u64 encode(float v, unsigned idx) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 ties with +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)b << 32) | idx;
}

// a key past the data: above every value key, unique by its position
__device__ __forceinline__ u64 pad_key(long long pos) {
  return (0xffffffffull << 32) | (0x80000000u | (unsigned)(pos & 0x7fffffff));
}

__device__ __forceinline__ bool is_pad(u64 key) {
  return ((unsigned)key & 0x80000000u) != 0u;
}

struct SelectShared {
  int hist[256];
  u64 prefix;
  int rem, done, count;
};

// The kk smallest of the m unique keys at `keys` (shared or device memory)
// into sel[0, kk), unordered.  Every thread of the block calls it.
__device__ void select_smallest(const u64* keys, int m, int kk, u64* sel,
                                SelectShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int mr = (m + blockDim.x - 1) / blockDim.x * blockDim.x;
  if (kk >= m) {
    for (int i = tid; i < m; i += blockDim.x) sel[i] = keys[i];
    __syncthreads();
    return;
  }
  u64 prefix = 0;
  int shift = 64, rem = kk;
  for (;;) {
    shift -= 8;
    for (int i = tid; i < 256; i += blockDim.x) sh.hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < mr; i += blockDim.x) {
      unsigned dig = 0xffffffffu;
      if (i < m) {
        const u64 key = keys[i];
        if (shift == 56 || (key >> (shift + 8)) == (prefix >> (shift + 8)))
          dig = (unsigned)(key >> shift) & 255u;
      }
      const unsigned same = __match_any_sync(0xffffffffu, dig);
      if (dig != 0xffffffffu && lane == __ffs(same) - 1)
        atomicAdd(&sh.hist[dig], __popc(same));
    }
    __syncthreads();
    if (tid < 32) {
      // lane owns bins 8 lane .. 8 lane + 7; find the bin holding the
      // rem-th smallest of the keys that share the prefix
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sh.hist[lane * 8 + j];
        sum += c[j];
      }
      int inc = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += t;
      }
      const int exc = inc - sum;
      if (exc < rem && rem <= inc) {
        int r = rem - exc, j = 0;
        while (r > c[j]) r -= c[j++];
        sh.prefix = prefix | ((u64)(lane * 8 + j) << shift);
        sh.rem = r;
        sh.done = c[j] == r;
      }
    }
    __syncthreads();
    prefix = sh.prefix;
    rem = sh.rem;
    // the bin is taken whole: every key whose digits down to this one are
    // at most the prefix's is selected (at shift 0 every bin holds one key)
    if (sh.done || shift == 0) break;
  }
  const u64 lim = prefix >> shift;
  if (tid == 0) sh.count = 0;
  __syncthreads();
  for (int i = tid; i < mr; i += blockDim.x) {
    const bool take = i < m && (keys[i] >> shift) <= lim;
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&sh.count, __popc(bal));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (take) sel[base + __popc(bal & ((1u << lane) - 1u))] = keys[i];
  }
  __syncthreads();
}

// sel[0, kk) unordered -> the first k outputs in key order, (+inf, -1)
// past kk and at padding; values are read back from the input by index
__device__ void write_sorted(const u64* sel, int kk, int k,
                             const float* __restrict__ values,
                             float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    const u64 key = sel[i];
    int rank = 0;
    for (int j = 0; j < kk; ++j) rank += sel[j] < key;
    if (is_pad(key)) {
      out_v[rank] = INFINITY;
      out_i[rank] = -1;
    } else {
      const int idx = (int)(unsigned)key;
      const float v = values[idx];
      out_v[rank] = v;
      out_i[rank] = v == INFINITY ? -1 : idx;
    }
  }
  for (int i = kk + threadIdx.x; i < k; i += blockDim.x) {
    out_v[i] = INFINITY;
    out_i[i] = -1;
  }
}

// One block per chunk: keys in shared memory, the chunk's k1 smallest out
// to surv[b * k1, (b + 1) * k1) (padded), or, with one chunk, the result.
__global__ void __launch_bounds__(kThreads)
    topk_chunks_kernel(const float* __restrict__ values, int n, int chunk,
                       int k1, int k, u64* __restrict__ surv,
                       float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ u64 sm[];
  __shared__ SelectShared sh;
  u64* keys = sm;
  u64* sel = sm + chunk;
  const int b = blockIdx.x;
  const long long base = (long long)b * chunk;
  const int m = (int)min((long long)chunk, n - base);
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    keys[i] = encode(values[base + i], (unsigned)(base + i));
  __syncthreads();
  const int kk = min(k1, m);
  select_smallest(keys, m, kk, sel, sh);
  if (gridDim.x == 1) {
    write_sorted(sel, kk, k, values, out_v, out_i);
    return;
  }
  for (int i = threadIdx.x; i < k1; i += blockDim.x)
    surv[(size_t)b * k1 + i] =
        i < kk ? sel[i] : pad_key((long long)b * k1 + i);
}

// One block over the m survivors: the k smallest, sorted, as the result.
__global__ void __launch_bounds__(kThreads)
    topk_merge_kernel(const u64* __restrict__ surv, int m, int k,
                      const float* __restrict__ values,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ u64 sm[];
  __shared__ SelectShared sh;
  const int kk = min(k, m);
  u64* sel = sm;
  const u64* keys = surv;
  if (m <= kStage2Cap) {
    u64* staged = sm + kk;
    for (int i = threadIdx.x; i < m; i += blockDim.x) staged[i] = surv[i];
    __syncthreads();
    keys = staged;
  }
  select_smallest(keys, m, kk, sel, sh);
  write_sorted(sel, kk, k, values, out_v, out_i);
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// n values in chunks of `chunk` (at most 8,192) -> out_v (k,), out_i (k,);
// `surv` holds ceil(n / chunk) * min(k, chunk) 64-bit keys.  One launch
// when n <= chunk, else two.
extern "C" int topk_f32(const void* values, void* out_v, void* out_i,
                        void* surv, int n, int k, int chunk, void* stream) {
  if (n == 0 || k == 0) return 0;
  if (chunk > kStage2Cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = (int)(((long long)n + chunk - 1) / chunk);
  const int k1 = std::min(k, chunk);
  const size_t smem1 = (size_t)(chunk + k1) * sizeof(u64);
  cudaError_t e = allow_smem((const void*)topk_chunks_kernel, smem1);
  if (e != cudaSuccess) return (int)e;
  topk_chunks_kernel<<<nb, kThreads, smem1, st>>>(
      (const float*)values, n, chunk, k1, k, (u64*)surv, (float*)out_v,
      (int*)out_i);
  e = cudaGetLastError();
  if (e != cudaSuccess || nb == 1) return (int)e;
  const long long m = (long long)nb * k1;
  if (m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int kk = (int)std::min((long long)k, m);
  const size_t smem2 =
      (size_t)(kk + (m <= kStage2Cap ? m : 0)) * sizeof(u64);
  e = allow_smem((const void*)topk_merge_kernel, smem2);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<1, kThreads, smem2, st>>>(
      (const u64*)surv, (int)m, k, (const float*)values, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
