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
// What bounds it on an H100: the work is 2*Q*d FP32 flops per valid row and
// 4*Q bytes of scores per row, padded or not.  Where a third of the rows
// are valid (the SIFT1M-shaped index's leaves hold about 500 rows of a
// 1,416-row tile), that is about 19 flops per byte at Q = 64 and d = 128,
// level with the FP32 ridge point of about 20 (the H100 SXM data sheet's
// 67 TFLOP/s over 3.35 TB/s, at its 700 W limit): the FP32 FMA rate and
// the (Q, U, C) score output bound it about equally.  The TPU kernel's
// grid re-read the query block and probed one bitmap word per (query, row)
// pair; on this card both are traffic the FMA units wait on.
//
// What the design does about it.  The (U, C) rows are one flat list of
// N = U * C rows, cut into items of 256 rows.  A first kernel turns the
// (Q, W) bitmap words into a (ceil(Q / 64), 32 W) table of 64-bit pass
// masks: bit q of masks[t][r] is query 64 t + q's bit for row id r, so a
// row is probed for all 64 queries of a tile with one 8-byte load.  The
// main kernel runs persistent blocks (about one per SM) that each own a
// tile of up to 64 queries, keep its query slice and ||q||^2 in shared
// memory, and walk their items:
// - an item whose 256 rows are all -1 padding gets +inf (float4 streaming
//   stores) and no product: a block votes on its rows' ids one item ahead;
// - the next item's int8 rows (16-byte cp.async pieces, swizzled so the
//   dequantizing reads do not conflict), its row norms and its pass masks
//   (8-byte cp.async gathers by row id, the row id loaded one item ahead)
//   are in flight while the current item is computed;
// - each item is dequantized once into a k-major f32 tile, rounding the
//   product and the sum separately (no fused multiply-add), as the plain
//   version does;
// - the product is a register-blocked FP32 tile (8 queries x 8 rows a
//   thread, 64 x 256 a block) over K slices of 128, no TF32;
// - the epilogue completes the L2 distance with the row norms, applies
//   the pass mask, and writes each query's scores along C as float4s
//   (streaming stores), so a warp writes whole 128-byte lines.
// d need not be a multiple of 16 (the rows are then staged by plain
// loads), and N need not be a multiple of 4 (scalar stores at the tail).
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

#include <algorithm>

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

typedef unsigned long long u64;

// one tile of queries, one item of rows, one K slice
constexpr int kQT = 64, kRows = 256, kKS = 128, kThreads = 256;
constexpr int kAStride = kKS + 4;   // query rows in shared memory, floats

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (Q, W) bitmap words -> (ceil(Q / 64), 32 W) pass masks: bit q of
// masks[t][r] is bit (r & 31) of word r >> 5 of query 64 t + q.  A block
// turns 8 words of 64 queries; a thread writes one row's mask.
__global__ void pass_masks_kernel(const unsigned* __restrict__ bitmaps,
                                  u64* __restrict__ masks, int Q, int W) {
  __shared__ unsigned words[kQT][9];
  const int w0 = blockIdx.x * 8, t = blockIdx.y, tid = threadIdx.x;
  for (int e = tid; e < kQT * 8; e += blockDim.x) {
    const int q = e >> 3, w = e & 7;
    const int gq = t * kQT + q, gw = w0 + w;
    words[q][w] = (gq < Q && gw < W) ? __ldg(bitmaps + (size_t)gq * W + gw)
                                     : 0u;
  }
  __syncthreads();
  const int w = tid >> 5, b = tid & 31;
  if (w0 + w >= W) return;
  u64 m = 0;
#pragma unroll 16
  for (int q = 0; q < kQT; ++q)
    m |= (u64)((words[q][w] >> b) & 1u) << q;
  masks[(size_t)t * W * 32 + (size_t)(w0 + w) * 32 + b] = m;
}

struct BatchedArgs {
  const float* queries;       // (Q, d)
  const signed char* tiles;   // (N, d), N = U * C
  const float* scale;         // (d,)
  const float* mean;          // (d,)
  const int* rowids;          // (N,)
  const float* norms;         // (N,)
  const u64* masks;           // (ceil(Q / 64), mstride)
  float* out;                 // (Q, N)
  long long mstride;          // 32 W
  int Q, N, d, nslices, metric, tiles16, vec_out;
};

// Stage one K slice of one item's rows: 16-byte pieces, piece j of row r at
// column (j ^ (r & 7)) of the row's 128 bytes, zero past d and past N.
__device__ __forceinline__ void stage_rows(const BatchedArgs& a,
                                           signed char* stage, int item,
                                           int s) {
  for (int p = threadIdx.x; p < kRows * 8; p += kThreads) {
    const int r = p >> 3, j = p & 7;
    const long long g = (long long)item * kRows + r;
    const int k0 = s * kKS + j * 16;
    signed char* dst = stage + r * kKS + ((j ^ (r & 7)) << 4);
    const bool ok = g < a.N && k0 < a.d;
    if (a.tiles16) {
      cp_async16(dst, ok ? a.tiles + g * a.d + k0 : a.tiles, ok ? 16 : 0);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (ok)
        for (int e = 0; e < 16 && k0 + e < a.d; ++e)
          w[e >> 2] |= (unsigned)(unsigned char)a.tiles[g * a.d + k0 + e]
                       << (8 * (e & 3));
      *reinterpret_cast<int4*>(dst) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  }
}

__device__ __forceinline__ int load_rowid(const BatchedArgs& a, int item,
                                          int nitems) {
  const long long g = (long long)item * kRows + threadIdx.x;
  return (item < nitems && g < a.N) ? __ldg(a.rowids + g) : -1;
}

// One item's row norms and its rows' pass masks (gathered by row id; a
// padded row gets mask 0, so every query reads +inf there).
__device__ __forceinline__ void stage_row_data(const BatchedArgs& a,
                                               const u64* mtile, float* nrm,
                                               u64* msk, int item, int rid) {
  const int r = threadIdx.x;
  const long long g = (long long)item * kRows + r;
  const bool in = g < a.N;
  cp_async4(nrm + r, in ? a.norms + g : a.norms, in ? 4 : 0);
  const bool ok = in && rid >= 0 && rid < a.mstride;
  cp_async8(msk + r, ok ? mtile + rid : mtile, ok ? 8 : 0);
}

// +inf over one item's scores for the block's queries.
__device__ __forceinline__ void fill_inf(const BatchedArgs& a, int item,
                                         int q0, int nq) {
  const long long g0 = (long long)item * kRows;
  for (int e = threadIdx.x; e < nq * (kRows / 4); e += kThreads) {
    const int ql = e / (kRows / 4), c = (e % (kRows / 4)) * 4;
    float* o = a.out + (size_t)(q0 + ql) * a.N + g0 + c;
    if (a.vec_out && g0 + c + 3 < a.N) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(INFINITY, INFINITY, INFINITY, INFINITY));
    } else {
      for (int j = 0; j < 4; ++j)
        if (g0 + c + j < a.N) o[j] = INFINITY;
    }
  }
}

// The first item from `item` on (stepping by the grid) that holds a row;
// `rid` holds this thread's row id of `item` and then of the item returned.
// An item of -1 padding only gets +inf and no product.  Every thread of
// the block calls it.
__device__ __forceinline__ int next_live(const BatchedArgs& a, int item,
                                         int nitems, int& rid, int q0,
                                         int nq) {
  while (item < nitems && !__syncthreads_or(rid >= 0)) {
    fill_inf(a, item, q0, nq);
    item += gridDim.x;
    rid = load_rowid(a, item, nitems);
  }
  return item;
}

__global__ void __launch_bounds__(kThreads, 1)
    leaf_scan_batched_kernel(const BatchedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* msk = reinterpret_cast<u64*>(smem);                 // [2][kRows]
  float* Bs = reinterpret_cast<float*>(msk + 2 * kRows);    // [kKS][kRows]
  float* As = Bs + kKS * kRows;                             // [kQT][kAStride]
  signed char* stage =
      reinterpret_cast<signed char*>(As + kQT * kAStride);  // [kRows][kKS]
  float* nrm = reinterpret_cast<float*>(stage + kRows * kKS);  // [2][kRows]
  float* qn = nrm + 2 * kRows;                              // [kQT]
  float* sc = qn + kQT;                                     // [nslices*kKS]
  float* mn = sc + a.nslices * kKS;

  const int nitems = (int)(((long long)a.N + kRows - 1) / kRows);
  int item = blockIdx.x;
  if (item >= nitems) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * kQT;
  const int nq = min(kQT, a.Q - q0);
  const u64* mtile = a.masks + (size_t)blockIdx.y * a.mstride;

  // the first live item's loads go out before anything else
  int rid = load_rowid(a, item, nitems);
  item = next_live(a, item, nitems, rid, q0, nq);
  if (item >= nitems) return;
  stage_rows(a, stage, item, 0);
  stage_row_data(a, mtile, nrm, msk, item, rid);
  cp_async_commit();
  int rid_next = load_rowid(a, item + gridDim.x, nitems);

  for (int i = tid; i < a.nslices * kKS; i += kThreads) {
    sc[i] = i < a.d ? a.scale[i] : 0.f;
    mn[i] = i < a.d ? a.mean[i] : 0.f;
  }
  for (int r = warp; r < kQT; r += kThreads / 32) {
    float s = 0.f;
    if (r < nq)
      for (int k = lane; k < a.d; k += 32) {
        const float v = a.queries[(size_t)(q0 + r) * a.d + k];
        s += v * v;
      }
    s = warp_sum(s);
    if (lane == 0) qn[r] = s;
  }

  // the thread's 8 x 8 tile: queries wq + qg + 4 i, rows wr + rg * 4 + j
  // and wr + 32 + rg * 4 + j
  const int wq = (warp >> 2) * 32, wr = (warp & 3) * 64;
  const int qg = lane >> 3, rg = lane & 7;
  const float* Ap = As + (wq + qg) * kAStride;
  const float* Bp = Bs + wr + rg * 4;
  float acc[8][8];
  int buf = 0, next = nitems;
  bool as_loaded = false;
  for (;;) {
    for (int s = 0; s < a.nslices; ++s) {
      cp_async_wait_all();
      __syncthreads();
      if (!as_loaded) {
        for (int e = tid; e < kQT * kKS; e += kThreads) {
          const int r = e / kKS, k = e % kKS, gk = s * kKS + k;
          As[r * kAStride + k] =
              (r < nq && gk < a.d) ? a.queries[(size_t)(q0 + r) * a.d + gk]
                                   : 0.f;
        }
        as_loaded = a.nslices == 1;
      }
      {  // dequantize: thread tid owns row tid
        const int r = tid;
        const float4* sc4 = reinterpret_cast<const float4*>(sc + s * kKS);
        const float4* mn4 = reinterpret_cast<const float4*>(mn + s * kKS);
#pragma unroll 2
        for (int j = 0; j < 8; ++j) {
          const int4 v = *reinterpret_cast<const int4*>(
              stage + r * kKS + ((j ^ (r & 7)) << 4));
          const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                                 (unsigned)v.w};
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 s4 = sc4[j * 4 + e4], m4 = mn4[j * 4 + e4];
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float c =
                  (float)(signed char)((w[e4] >> (8 * e)) & 0xffu);
              Bs[(j * 16 + e4 * 4 + e) * kRows + r] =
                  __fadd_rn(__fmul_rn(c, sv[e]), mv[e]);
            }
          }
        }
      }
      __syncthreads();
      // the next step's rows go out while this one is computed
      if (s + 1 < a.nslices) {
        stage_rows(a, stage, item, s + 1);
      } else {
        next = next_live(a, item + gridDim.x, nitems, rid_next, q0, nq);
        if (next < nitems) {
          stage_rows(a, stage, next, 0);
          stage_row_data(a, mtile, nrm + (buf ^ 1) * kRows,
                         msk + (buf ^ 1) * kRows, next, rid_next);
          rid_next = load_rowid(a, next + gridDim.x, nitems);
        }
      }
      cp_async_commit();

      if (s == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
      const int kmax = min(kKS, (a.d - s * kKS + 3) & ~3);
#pragma unroll 2
      for (int k = 0; k < kmax; k += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(Ap + 4 * i * kAStride + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 =
              *reinterpret_cast<const float4*>(Bp + (k + kk) * kRows);
          const float4 b1 =
              *reinterpret_cast<const float4*>(Bp + (k + kk) * kRows + 32);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = kk == 0   ? av[i].x
                            : kk == 1 ? av[i].y
                            : kk == 2 ? av[i].z
                                      : av[i].w;
            acc[i][0] += x * b0.x;
            acc[i][1] += x * b0.y;
            acc[i][2] += x * b0.z;
            acc[i][3] += x * b0.w;
            acc[i][4] += x * b1.x;
            acc[i][5] += x * b1.y;
            acc[i][6] += x * b1.z;
            acc[i][7] += x * b1.w;
          }
        }
      }
    }

    // epilogue: this item's scores, each query's along C
    const long long g0 = (long long)item * kRows;
    float xn[8];
    u64 mk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wr + (j >> 2) * 32 + rg * 4 + (j & 3);
      xn[j] = nrm[buf * kRows + r];
      mk[j] = msk[buf * kRows + r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ql = wq + qg + 4 * i;
      if (ql >= nq) continue;
      const float qv = qn[ql];
      float* orow = a.out + (size_t)(q0 + ql) * a.N + g0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = wr + h * 32 + rg * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = h * 4 + j;
          const bool ok = (mk[jj] >> ql) & 1ull;
          v[j] = ok ? (a.metric == 1 ? -acc[i][jj]
                                     : qv + xn[jj] - 2.f * acc[i][jj])
                    : INFINITY;
        }
        if (a.vec_out && g0 + c + 3 < a.N) {
          __stcs(reinterpret_cast<float4*>(orow + c),
                 make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (g0 + c + j < a.N) orow[c + j] = v[j];
        }
      }
    }
    item = next;
    if (item >= nitems) break;
    buf ^= 1;
  }
}

size_t batched_smem_bytes(int nslices) {
  return 2 * kRows * sizeof(u64) + (size_t)kKS * kRows * sizeof(float) +
         (size_t)kQT * kAStride * sizeof(float) + (size_t)kRows * kKS +
         2 * kRows * sizeof(float) + kQT * sizeof(float) +
         2 * (size_t)nslices * kKS * sizeof(float);
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

// bitmaps (Q, W) -> masks (ceil(Q / 64), 32 W) scratch, then the scan.
// Refuses (cudaErrorInvalidValue) a d whose K slices and scale/mean do not
// fit the shared memory of one block.
extern "C" int leaf_scan_batched_f32(const void* queries, const void* tiles,
                                     const void* rowids, const void* scale,
                                     const void* mean, const void* bitmaps,
                                     const void* norms, void* masks,
                                     void* out, int Q, int U, int C, int d,
                                     int W, int metric, void* stream) {
  if (Q == 0 || U == 0 || C == 0) return 0;
  // read once from the current card: the process drives one card
  static int max_smem = -1, n_sm = 0;
  if (max_smem < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      max_smem = -1;
      return (int)e;
    }
  }
  const int nslices = (d + kKS - 1) / kKS;
  const size_t smem = batched_smem_bytes(nslices);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      leaf_scan_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nqt = (Q + kQT - 1) / kQT;
  pass_masks_kernel<<<dim3((W + 7) / 8, nqt), kThreads, 0, st>>>(
      (const unsigned*)bitmaps, (u64*)masks, Q, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  BatchedArgs a;
  a.queries = (const float*)queries;
  a.tiles = (const signed char*)tiles;
  a.scale = (const float*)scale;
  a.mean = (const float*)mean;
  a.rowids = (const int*)rowids;
  a.norms = (const float*)norms;
  a.masks = (const u64*)masks;
  a.out = (float*)out;
  a.mstride = 32LL * W;
  a.Q = Q;
  a.N = U * C;
  a.d = d;
  a.nslices = nslices;
  a.metric = metric;
  a.tiles16 = d % 16 == 0 && (size_t)tiles % 16 == 0;
  a.vec_out = a.N % 4 == 0 && (size_t)out % 16 == 0;
  const int nitems = (a.N + kRows - 1) / kRows;
  const int per_tile = std::max(1, n_sm / nqt);
  leaf_scan_batched_kernel<<<dim3(std::min(nitems, per_tile), nqt), kThreads,
                             smem, st>>>(a);
  return (int)cudaGetLastError();
}
