// distance_matrix: (Q, N) L2 or inner-product distances between two row sets.
//
// Replaces the Pallas kernel `_dist_kernel` of src/repro/kernels/distance.py
// (called through `distance_matrix_pallas`): the ScaNN centroid levels score
// every query of a block against the branch and leaf centroids with it.
// L2 is ||q||^2 + ||x||^2 - 2 q.x with both norms reduced in the kernel from
// the tiles it already holds, so no second pass over either input is made;
// inner product is -q.x.  Everything is FP32 FMA (no TF32): ScaNN ranks its
// leaves on these numbers.
//
// What bounds it on an H100: at the search path's shapes (Q = a query
// block of 64, N = 2000 leaf or 44 branch centroids, d = 128) the work is
// 33 MFLOP and 1.6 MB, 0.5 us of FP32 FMA and of memory traffic: latency
// bounds it, the launch, one trip to memory and the time a block needs to
// run its products, not the flops or the bytes.
//
// What the design does about it: enough blocks to cover the 132 SMs at both
// shapes, and one trip to memory a block.  A block owns 16 centroids and BM
// query rows: BM = 64 (256 threads, each 4 rows x 1 centroid) while that
// gives at least 66 blocks (125 at N = 2000), else 16, 4 or 1 rows (16 BM
// threads, one output each) down to the first that gives 132 blocks (at
// N = 44: 64 x 3 = 192 blocks of 1 row).  Each block stages its whole
// d-slice of both inputs (up to 128 columns at once; wider rows take more
// rounds) with 16-byte cp.async copies and waits once; the loop over the
// staged columns then runs with no barrier, and the same loop sums the
// squares of the values it reads, which gives both norms from the staged
// tiles (in column order, so a run repeats bit for bit).  Rows are padded by 4
// floats in shared memory so that 8 threads reading 8 centroids' float4s
// hit 8 different bank groups.  Partial tiles are zero-filled on load and
// masked on store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 16;              // centroids a block
constexpr int DC = 128;             // columns staged a round
constexpr int LD = DC + 4;          // padded row stride in shared memory
constexpr int THREADS = 256;
constexpr int MAX_BM = 64;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Stage rows [r0, r0 + nrows) x columns [c0, c0 + DC) of an (n, d) matrix
// into s (nrows x LD), zeros past n and past d.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g,
                                      int r0, int nrows, int n, int d, int c0,
                                      bool vec, int tid, int nthreads) {
  if (vec) {
    for (int e = tid; e < nrows * (DC / 4); e += nthreads) {
      const int r = e / (DC / 4), c = (e % (DC / 4)) * 4;
      float* dst = s + r * LD + c;
      if (r0 + r < n && c0 + c < d)
        cp_async16(dst, g + (size_t)(r0 + r) * d + c0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < nrows * DC; e += nthreads) {
      const int r = e / DC, c = e % DC;
      s[r * LD + c] = (r0 + r < n && c0 + c < d)
                          ? g[(size_t)(r0 + r) * d + c0 + c] : 0.f;
    }
  }
}

// TM query rows a thread: BM = 16 TM rows x 16 centroids a block of 256
// threads (TM = 4), or BM = blockDim.y rows of 16 threads (TM = 1).
template <int TM>
__global__ void __launch_bounds__(THREADS)
distance_matrix_kernel(const float* __restrict__ q,
                       const float* __restrict__ x, float* __restrict__ out,
                       int Q, int N, int d, int metric, int vec) {
  __shared__ __align__(16) float qs[MAX_BM * LD];
  __shared__ __align__(16) float xs[BN * LD];

  const int tx = threadIdx.x, ty = threadIdx.y;   // tx: centroid
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * BN + tx;
  const int bm = TM * blockDim.y;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * BN;

  // the products of centroid tx with rows ty + i blockDim.y, and the norms
  // of both from the same staged values, each summed in column order
  float acc[TM] = {}, qn[TM] = {}, xn = 0.f;
  for (int c0 = 0; c0 < d; c0 += DC) {
    if (c0 > 0) __syncthreads();      // the previous round is read
    stage(qs, q, m0, bm, Q, d, c0, vec, tid, nthreads);
    stage(xs, x, n0, BN, N, d, c0, vec, tid, nthreads);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const float4* xr = reinterpret_cast<const float4*>(xs + tx * LD);
#pragma unroll 8
    for (int c = 0; c < DC / 4; ++c) {
      const float4 b = xr[c];
      xn = fmaf(b.x, b.x, xn);
      xn = fmaf(b.y, b.y, xn);
      xn = fmaf(b.z, b.z, xn);
      xn = fmaf(b.w, b.w, xn);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = reinterpret_cast<const float4*>(
            qs + (ty + i * blockDim.y) * LD)[c];
        acc[i] = fmaf(a.x, b.x, acc[i]);
        acc[i] = fmaf(a.y, b.y, acc[i]);
        acc[i] = fmaf(a.z, b.z, acc[i]);
        acc[i] = fmaf(a.w, b.w, acc[i]);
        qn[i] = fmaf(a.x, a.x, qn[i]);
        qn[i] = fmaf(a.y, a.y, qn[i]);
        qn[i] = fmaf(a.z, a.z, qn[i]);
        qn[i] = fmaf(a.w, a.w, qn[i]);
      }
    }
  }
  const int gn = n0 + tx;
  if (gn >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty + i * blockDim.y;
    if (gr >= Q) continue;
    out[(size_t)gr * N + gn] =
        metric == 1 ? -acc[i] : qn[i] + xn - 2.f * acc[i];
  }
}

}  // namespace

extern "C" int distance_matrix_f32(const void* q, const void* x, void* out,
                                   int Q, int N, int d, int metric,
                                   void* stream) {
  if (Q == 0 || N == 0) return 0;
  const int vec = d % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  const int nb = (N + BN - 1) / BN;
  cudaStream_t st = (cudaStream_t)stream;
  if ((long)((Q + 63) / 64) * nb >= 66) {
    dim3 grid(nb, (Q + 63) / 64);
    distance_matrix_kernel<4><<<grid, dim3(BN, 16), 0, st>>>(
        (const float*)q, (const float*)x, (float*)out, Q, N, d, metric, vec);
  } else {
    int bm = 16;
    while (bm > 1 && (long)((Q + bm - 1) / bm) * nb < 132) bm /= 4;
    dim3 grid(nb, (Q + bm - 1) / bm);
    distance_matrix_kernel<1><<<grid, dim3(BN, bm), 0, st>>>(
        (const float*)q, (const float*)x, (float*)out, Q, N, d, metric, vec);
  }
  return (int)cudaGetLastError();
}
