// frontier_scan: one graph superstep's candidate scoring + filter probe,
// in four variants that share one kernel template.
//
// Replaces the Pallas kernels of src/repro/kernels/frontier_scan.py:
//   frontier_scan_f32       <- `frontier_scan_pallas`          (:92)
//   frontier_scan_sq8       <- `frontier_scan_sq8_pallas`      (:164)
//   frontier_scan_excl_f32  <- `frontier_scan_excl_pallas`     (:240)
//   frontier_scan_excl_sq8  <- `frontier_scan_excl_sq8_pallas` (:322)
// For every (query, candidate id) it returns the L2 distance
// ||q||^2 + ||x||^2 - 2 q.x (precomputed ||x||^2) or the negated inner
// product, +inf where the id is -1 padding, and the bit of the query's
// packed filter bitmap for that id.  The SQ8 variants read int8 shadow rows
// and dequantize in the kernel (x = t * scale + mean, ||x||^2 precomputed
// from the dequantized rows).  The exclusion variants add the FAVOR keep
// mask: keep = pass | sqrt(e) <= margin * (sqrt(d) + sqrt(tau)) on the
// +inf-masked distance, with e the candidate's squared exclusion radius,
// read from row `radius_row[q]` of an (R + F, n) radius table, and tau the
// query's current result-queue tail.
//
// What bounds it on an H100: it is a gather-GEMV.  Each candidate row
// (4d bytes f32, d bytes int8) is read once, with its norm, id, bitmap word
// and, for the exclusion variants, its radius, and nothing is reused across
// candidates, so it moves about Q*C*(4d + 12) bytes (Q*C*(d + 12) for SQ8)
// for 2*Q*C*d flops: memory bound, far below the FP32 ridge point.
//
// What the design does about it: the TPU kernels received an already
// gathered (Q, C, d) block; here the kernel gathers each row by id from
// the (n, d) store itself, so that block is never written to or read back
// from device memory, and the radius is gathered the same way, so no
// (Q, n) radius block exists either.  One warp scores one (query,
// candidate): its 32 lanes read the row with coalesced loads (16 bytes a
// lane for f32, 4 bytes a lane for int8: a d = 128 SQ8 row is one 128-byte
// transaction, a quarter of the f32 row's bytes), multiply against the
// query held in shared memory (with scale and mean beside it for SQ8), and
// reduce with warp shuffles.  Lane 0 completes the distance, probes the
// bitmap word and evaluates the keep rule.  A block of 8 warps shares one
// query, loaded into shared memory once.  Built without --use_fast_math, so
// sqrtf stays correctly rounded; nvcc may still contract the dequantization
// and the distance completion into FMAs, a few ulp from the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Excl {
  const float* table;    // (R + F, n) squared exclusion radii
  const int* row;        // (Q,) row of the table each query reads
  const float* tau;      // (Q,) current result-queue tail
  unsigned char* keep;   // (Q, C) out
  float margin;
};

// SQ8: rows are int8 and the shared block holds query, scale and mean.
template <bool SQ8, bool EXCL>
__global__ void frontier_scan_kernel(const float* __restrict__ queries,
                                     const void* __restrict__ rows_,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ norms,
                                     const int* __restrict__ ids,
                                     const int* __restrict__ bitmaps,
                                     float* __restrict__ dist,
                                     unsigned char* __restrict__ pass,
                                     Excl ex, int C, int d, int W, int n,
                                     int metric, int vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int dpad = (d + 3) & ~3;
  float* ss = qs + dpad;          // SQ8 only: scale, then mean
  float* ms = ss + dpad;
  const int qi = blockIdx.y;
  const float* qrow = queries + (size_t)qi * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    qs[i] = qrow[i];
    if (SQ8) {
      ss[i] = scale[i];
      ms[i] = mean[i];
    }
  }
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
      // +inf distance: sqrt(e) <= margin * inf holds for any radius
      if (EXCL) ex.keep[o] = 1;
    }
    return;
  }
  float ip = 0.f, qq = 0.f;
  if (SQ8) {
    const int8_t* t = reinterpret_cast<const int8_t*>(rows_) + (size_t)id * d;
    if (vec4) {
      const char4* t4 = reinterpret_cast<const char4*>(t);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const float4* s4 = reinterpret_cast<const float4*>(ss);
      const float4* m4 = reinterpret_cast<const float4*>(ms);
      for (int i = lane; i < (d >> 2); i += 32) {
        const char4 a = __ldg(t4 + i);
        const float4 b = q4[i], s = s4[i], m = m4[i];
        const float x0 = (float)a.x * s.x + m.x, x1 = (float)a.y * s.y + m.y;
        const float x2 = (float)a.z * s.z + m.z, x3 = (float)a.w * s.w + m.w;
        ip += x0 * b.x + x1 * b.y + x2 * b.z + x3 * b.w;
        qq += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float b = qs[i];
        ip += ((float)__ldg(t + i) * ss[i] + ms[i]) * b;
        qq += b * b;
      }
    }
  } else {
    const float* x = reinterpret_cast<const float*>(rows_) + (size_t)id * d;
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
  }
  ip = warp_sum(ip);
  qq = warp_sum(qq);
  if (lane == 0) {
    const float dd = metric == 1 ? -ip : qq + __ldg(norms + id) - 2.f * ip;
    const unsigned word = (unsigned)__ldg(bitmaps + (size_t)qi * W + (id >> 5));
    const unsigned char ok = (unsigned char)((word >> (id & 31)) & 1u);
    dist[o] = dd;
    pass[o] = ok;
    if (EXCL) {
      const float e = __ldg(ex.table + (size_t)__ldg(ex.row + qi) * n + id);
      const float tau = __ldg(ex.tau + qi);
      const float er = sqrtf(fmaxf(e, 0.f));
      const float bound = ex.margin * (sqrtf(fmaxf(dd, 0.f)) + sqrtf(fmaxf(tau, 0.f)));
      ex.keep[o] = (unsigned char)(ok | (er <= bound ? 1 : 0));
    }
  }
}

template <bool SQ8, bool EXCL>
int launch(const void* queries, const void* rows, const void* scale,
           const void* mean, const void* norms, const void* ids,
           const void* bitmaps, void* dist, void* pass, Excl ex, int Q, int C,
           int d, int W, int n, int metric, int vec4, void* stream) {
  if (Q == 0 || C == 0) return 0;
  dim3 grid((C + kWarps - 1) / kWarps, Q);
  const size_t smem = (size_t)(SQ8 ? 3 : 1) * ((d + 3) / 4) * sizeof(float4);
  frontier_scan_kernel<SQ8, EXCL><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, rows, (const float*)scale, (const float*)mean,
      (const float*)norms, (const int*)ids, (const int*)bitmaps,
      (float*)dist, (unsigned char*)pass, ex, C, d, W, n, metric, vec4);
  return (int)cudaGetLastError();
}

Excl make_excl(const void* table, const void* row, const void* tau,
               void* keep, float margin) {
  Excl ex;
  ex.table = (const float*)table;
  ex.row = (const int*)row;
  ex.tau = (const float*)tau;
  ex.keep = (unsigned char*)keep;
  ex.margin = margin;
  return ex;
}

}  // namespace

extern "C" int frontier_scan_f32(const void* queries, const void* rows,
                                 const void* norms, const void* ids,
                                 const void* bitmaps, void* dist, void* pass,
                                 int Q, int C, int d, int W, int n,
                                 int metric, int vec4, void* stream) {
  return launch<false, false>(queries, rows, nullptr, nullptr, norms, ids,
                              bitmaps, dist, pass,
                              make_excl(nullptr, nullptr, nullptr, nullptr, 0.f),
                              Q, C, d, W, n, metric, vec4, stream);
}

extern "C" int frontier_scan_sq8(const void* queries, const void* qrows,
                                 const void* scale, const void* mean,
                                 const void* norms, const void* ids,
                                 const void* bitmaps, void* dist, void* pass,
                                 int Q, int C, int d, int W, int n,
                                 int metric, int vec4, void* stream) {
  return launch<true, false>(queries, qrows, scale, mean, norms, ids, bitmaps,
                             dist, pass,
                             make_excl(nullptr, nullptr, nullptr, nullptr, 0.f),
                             Q, C, d, W, n, metric, vec4, stream);
}

extern "C" int frontier_scan_excl_f32(const void* queries, const void* rows,
                                      const void* norms, const void* ids,
                                      const void* bitmaps, const void* table,
                                      const void* radius_row, const void* tau,
                                      void* dist, void* pass, void* keep,
                                      float margin, int Q, int C, int d,
                                      int W, int n, int metric, int vec4,
                                      void* stream) {
  return launch<false, true>(queries, rows, nullptr, nullptr, norms, ids,
                             bitmaps, dist, pass,
                             make_excl(table, radius_row, tau, keep, margin),
                             Q, C, d, W, n, metric, vec4, stream);
}

extern "C" int frontier_scan_excl_sq8(const void* queries, const void* qrows,
                                      const void* scale, const void* mean,
                                      const void* norms, const void* ids,
                                      const void* bitmaps, const void* table,
                                      const void* radius_row, const void* tau,
                                      void* dist, void* pass, void* keep,
                                      float margin, int Q, int C, int d,
                                      int W, int n, int metric, int vec4,
                                      void* stream) {
  return launch<true, true>(queries, qrows, scale, mean, norms, ids, bitmaps,
                            dist, pass,
                            make_excl(table, radius_row, tau, keep, margin),
                            Q, C, d, W, n, metric, vec4, stream);
}
