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
// the row id is -1, the leaf id lies outside [0, L), or the row fails the
// query's bitmap.  Output (Q, nl, C).
//
// What bounds it on an H100: the bytes.  The queries of one batch open far
// fewer distinct leaves than (query, leaf) pairs (about 2,000 leaves for
// 40,000 slots at the SIFT1M-shaped main path), so read once per distinct
// leaf the tiles are about 0.37 GB, and the (Q, nl, C) score output is
// 0.23 GB.  On top of that each (query, valid row) probes one bitmap bit,
// about 20 M probes at random row ids: as 4-byte gathers from the (Q, W)
// bitmaps each costs its own 32-byte sector (up to about 0.19 ms at HBM
// rate; gathered so inside this kernel they took 0.6 ms on an H100).
// The work, 2 d flops per (query, valid row), is about 5 GFLOP (0.08 ms of
// FP32 at 67 TFLOP/s).  Scanned per (query, leaf) pair, as the TPU
// kernel's grid does, every pair re-reads its tile (7.3 GB) and redoes the
// dequantization and ||x||^2 about 20 times per distinct row.
//
// What the design does about it: the slots are grouped by leaf, each leaf
// is scored once against all the queries that opened it, and the probes
// read a row's bits for every query from one place.
// - Grouping, on the card with no host sync: a counting sort of the
//   (Q, nl) slots by leaf id (counts, one block's exclusive scan, a
//   scatter by atomic cursor).  Slots whose leaf id is outside [0, L) form
//   a bucket of their own that gets no work.  The scan cuts each leaf's
//   group into chunks of up to kG = 32 queries (the main path's groups
//   average 20, median 18, at most ~120) and lists one unit per (chunk,
//   run of kR = 256 rows that holds a row id >= 0): a run of -1 padding
//   gets no product.
// - The bitmaps are turned by row id first ((32 W, 4 ceil(Q / 128))
//   words: a row's bits for 1,024 queries in one 128-byte line; 32 x 32
//   bit blocks transposed in registers), so a unit stages each of its
//   rows' bits with eight 16-byte copies instead of one sector a query.
// - A fill pass writes +inf over the whole output first (float4 streaming
//   stores); the units then overwrite their live runs.  Padding runs,
//   invalid leaves and rows past C need no other work.
// - The scan runs persistent blocks (one per SM) over the units, with
//   leaf_scan_batched's machinery: the next unit's int8 rows are staged by
//   16-byte cp.async pieces (swizzled) while the current one is computed;
//   each unit is dequantized once into a k-major f32 tile (two rows and
//   half of K a thread, the code turned to float by a byte permute rather
//   than the quarter-rate int-to-float, the product and the sum rounded
//   separately: no fused multiply-add), ||x||^2 summed over each K half
//   and the two halves added in order; the unit's queries are gathered by
//   id into shared memory; the product is a register-blocked FP32 tile (4
//   queries x 8 rows a thread, 32 x 256 a block, no TF32), and a warp whose
//   16 queries are all past the chunk's end skips it.  The pass bits are
//   staged at the start of the unit and read in the epilogue.  The unit
//   list, row ids and query slots are loaded one unit ahead.  The product
//   reads three 16-byte shared-memory vectors for 32 FMAs a k, so shared
//   memory, not the FMA rate, bounds it (about two thirds of the FMA rate
//   at best); a larger tile a thread needs more queries a unit than the
//   groups hold or more rows than shared memory does.
// - The epilogue writes each query's scores along C as float4 streaming
//   stores into out[q, j, :].
// Each output's arithmetic depends on (q, j, c) alone (one thread, the same
// K order and rounding whatever else shares its unit), so the result is
// bit-identical under any order of the queries and from run to run, though
// the atomic scatter orders a group's slots differently each time.
// d need not be a multiple of 16 (rows then staged by plain loads) or of 4
// (queries then staged 4 bytes at a time); d <= 13 * 128 (the shared
// memory of one block).  Past 1,024 queries a unit gathers one 4-byte word
// of its row's bits a query.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
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

// ---------------------------------------------------------------------------
// leaf_scan: the (Q, nl) slots grouped by leaf, each leaf scored once
// against the queries that opened it
// ---------------------------------------------------------------------------

// queries a unit, rows a unit (one per thread), a block's threads
constexpr int kG = 32, kR = 256;
static_assert(kR == kThreads, "a thread owns one row of a unit");
constexpr int kScanThreads = 1024;

// A unit: `rows` [r0, r0 + kR) of leaf `leaf` against the `nq` queries whose
// flat slots (q * nl + j) are slots[start, start + nq).
struct Unit {
  int leaf, r0, start, nq;
};

// the bucket of a slot's leaf id: the leaf, or L for an id outside [0, L)
__device__ __forceinline__ int bucket(int leaf, int L) {
  return (leaf >= 0 && leaf < L) ? leaf : L;
}

// One warp a query: ||q||^2 and the query's slots counted into their
// buckets.
__global__ void group_count_kernel(const float* __restrict__ queries,
                                   const int* __restrict__ leaf_ids,
                                   int* __restrict__ counts,
                                   float* __restrict__ qnorm, int Q, int nl,
                                   int L, int d) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  for (int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); q < Q;
       q += nwarps) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = queries[(size_t)q * d + k];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) qnorm[q] = s;
    for (int j = lane; j < nl; j += 32)
      atomicAdd(counts + bucket(leaf_ids[(size_t)q * nl + j], L), 1);
  }
}

// One warp a (leaf, run of kR rows) of the opened leaves: live = some row
// id >= 0.
__global__ void live_runs_kernel(const int* __restrict__ rowids,
                                 const int* __restrict__ counts,
                                 int* __restrict__ live, int L, int C,
                                 int nruns) {
  const int lane = threadIdx.x & 31;
  const long long ntasks = (long long)L * nruns;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       t < ntasks; t += nwarps) {
    const int b = (int)(t / nruns), r0 = (int)(t % nruns) * kR;
    if (counts[b] == 0) continue;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kR / 32; ++i) {
      const int c = r0 + i * 32 + lane;
      any |= c < C && rowids[(size_t)b * C + c] >= 0;
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[t] = any;
  }
}

// Block-wide exclusive sum of one value a thread; `total` gets the sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanThreads / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;               // inclusive over warps
  }
  __syncthreads();
  total = warp_tot[kScanThreads / 32 - 1];
  const int before = warp ? warp_tot[warp - 1] : 0;
  __syncthreads();                    // warp_tot is reused by the next call
  return before + x - v;
}

// One block: the buckets' slot offsets (the scatter's cursors) and the unit
// list, bucket by bucket, each bucket's chunks of kG slots in order, each
// chunk's live runs in order.  The bucket of invalid leaf ids gets no unit.
__global__ void __launch_bounds__(kScanThreads)
    group_scan_kernel(const int* __restrict__ counts,
                      const int* __restrict__ live, int* __restrict__ cursor,
                      Unit* __restrict__ units, int* __restrict__ n_units,
                      int L, int nruns) {
  __shared__ int warp_tot[kScanThreads / 32];
  int slot_base = 0, unit_base = 0;
  for (int b0 = 0; b0 <= L; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int cnt = b <= L ? counts[b] : 0;
    int nlive = 0;
    if (b < L && cnt > 0)
      for (int r = 0; r < nruns; ++r) nlive += live[(size_t)b * nruns + r];
    const int nchunks = (cnt + kG - 1) / kG;
    int slots_total, units_total;
    const int slot_off =
        slot_base + block_exclusive_sum(cnt, warp_tot, slots_total);
    int u = unit_base +
            block_exclusive_sum(nchunks * nlive, warp_tot, units_total);
    if (b <= L) cursor[b] = slot_off;
    if (nlive > 0)
      for (int ch = 0; ch < nchunks; ++ch)
        for (int r = 0; r < nruns; ++r)
          if (live[(size_t)b * nruns + r])
            units[u++] = Unit{b, r * kR, slot_off + ch * kG,
                              min(kG, cnt - ch * kG)};
    slot_base += slots_total;
    unit_base += units_total;
  }
  if (threadIdx.x == 0) *n_units = unit_base;
}

// One thread a slot: its flat index into its bucket's next free place.
__global__ void group_scatter_kernel(const int* __restrict__ leaf_ids,
                                     int* __restrict__ cursor,
                                     int* __restrict__ slots, int n, int L) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += gridDim.x * blockDim.x)
    slots[atomicAdd(cursor + bucket(leaf_ids[s], L), 1)] = s;
}

// The 32 x 32 bit matrix x[0..31] transposed in place: bit b of x[q]
// becomes bit q of x[b].
__device__ __forceinline__ void transpose32(unsigned (&x)[32]) {
  unsigned m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
#pragma unroll
    for (int b = 0; b < 32; b += 2 * j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        const unsigned t = ((x[b + i] >> j) ^ x[b + i + j]) & m;
        x[b + i] ^= t << j;
        x[b + i + j] ^= t;
      }
    }
  }
}

// (Q, W) bitmap words -> (32 W, WQ) words by row id, WQ >= ceil(Q / 32):
// bit l of by_row[id][g] is query 32 g + l's bit for row id, so the bits
// of one row for every query lie together (128 bytes for Q <= 1,024).  A
// block turns 32 words (1,024 ids) for 8 groups of 32 queries: a warp reads
// its group's 32 rows of 32 words (128-byte loads), each lane transposes
// its word's 32 x 32 bits in registers, and the block writes 32 bytes of
// each of the 1,024 rows, 16 bytes a store (by_row 16-byte aligned, WQ a
// multiple of 4).
__global__ void bits_by_row_kernel(const unsigned* __restrict__ bitmaps,
                                   unsigned* __restrict__ by_row, int Q,
                                   int W, int WQ) {
  __shared__ unsigned res[32 * 32 * 9];   // [bit][word][group], padded
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the blocks of one set of rows run together, so each 128-byte row is
  // written whole while it is in L2
  const int ny = (WQ + 7) / 8;
  const int w0 = blockIdx.x / ny * 32, g0 = blockIdx.x % ny * 8;
  const int g = g0 + warp, w = w0 + lane;
  unsigned x[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const int q = g * 32 + l;
    x[l] = (g < WQ && q < Q && w < W) ? __ldg(bitmaps + (size_t)q * W + w)
                                      : 0u;
  }
  transpose32(x);   // x[b]: bit l = query 32 g + l's bit for id 32 w + b
#pragma unroll
  for (int b = 0; b < 32; ++b) res[(b * 32 + lane) * 9 + warp] = x[b];
  __syncthreads();
  for (int e = threadIdx.x; e < 1024 * 2; e += 256) {
    const int r = e >> 1, gl = (e & 1) * 4;      // row id 32 w0 + r
    const unsigned* src = res + ((r & 31) * 32 + (r >> 5)) * 9 + gl;
    if (w0 + (r >> 5) < W && g0 + gl < WQ)
      *reinterpret_cast<uint4*>(by_row + (size_t)(32 * w0 + r) * WQ + g0 +
                                gl) = make_uint4(src[0], src[1], src[2],
                                                 src[3]);
  }
}

// +inf over n floats.
__global__ void fill_inf_kernel(float* __restrict__ out, long long n,
                                int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = i0; i < n / 4; i += stride) __stcs(o4 + i, inf4);
    done = n / 4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) out[i] = INFINITY;
}

struct ScanArgs {
  const float* queries;      // (Q, d)
  const signed char* tiles;  // (L, C, d)
  const int* rowids;         // (L, C)
  const float* scale;        // (d,)
  const float* mean;         // (d,)
  const unsigned* by_row;    // (32 W, WQ) bits by row id, WQ % 4 == 0
  const Unit* units;         // (*n_units,)
  const int* n_units;
  const int* slots;          // (Q * nl,) flat slots, grouped by bucket
  const float* qnorm;        // (Q,)
  float* out;                // (Q, nl, C)
  int nl, C, d, W, WQ, nslices, metric, tiles16, q16, vec_out, whole_rows;
};

__device__ __forceinline__ Unit load_unit(const ScanArgs& a, int u, int n) {
  if (u >= n) return Unit{-1, 0, 0, 0};
  const int4 v = __ldg(reinterpret_cast<const int4*>(a.units) + u);
  return Unit{v.x, v.y, v.z, v.w};
}

// this thread's row id of unit e (-1 past C or for no unit)
__device__ __forceinline__ int unit_rowid(const ScanArgs& a, const Unit& e) {
  const int c = e.r0 + threadIdx.x;
  return (e.leaf >= 0 && c < a.C) ? __ldg(a.rowids + (size_t)e.leaf * a.C + c)
                                  : -1;
}

// the flat slot of query `ql` of unit e, or -1
__device__ __forceinline__ int unit_slot(const ScanArgs& a, const Unit& e,
                                         int ql) {
  return (e.leaf >= 0 && ql < e.nq) ? __ldg(a.slots + e.start + ql) : -1;
}

// Stage one K slice of a unit's rows: 16-byte pieces, piece j of row r at
// column (j ^ ((r >> 1) & 7)) of the row's 128 bytes, zero past d and
// past C.
__device__ __forceinline__ void stage_unit_rows(const ScanArgs& a,
                                                signed char* stage,
                                                const Unit& e, int s) {
  for (int p = threadIdx.x; p < kR * 8; p += kThreads) {
    const int r = p >> 3, j = p & 7;
    const int c = e.r0 + r, k0 = s * kKS + j * 16;
    const long long g = (long long)e.leaf * a.C + c;
    signed char* dst = stage + r * kKS + ((j ^ ((r >> 1) & 7)) << 4);
    const bool ok = c < a.C && k0 < a.d;
    if (a.tiles16) {
      cp_async16(dst, ok ? a.tiles + g * a.d + k0 : a.tiles, ok ? 16 : 0);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (ok)
        for (int el = 0; el < 16 && k0 + el < a.d; ++el)
          w[el >> 2] |= (unsigned)(unsigned char)a.tiles[g * a.d + k0 + el]
                        << (8 * (el & 3));
      *reinterpret_cast<int4*>(dst) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  }
}

// Stage one K slice of the unit's queries: thread t copies 16 floats of
// query t >> 3 (q = -1 past the chunk: zeros), zero past d.
__device__ __forceinline__ void stage_unit_queries(const ScanArgs& a,
                                                   float* As, int q, int s) {
  const int ql = threadIdx.x >> 3, part = threadIdx.x & 7;
  float* dst = As + ql * kAStride + part * 16;
  const int k0 = s * kKS + part * 16;
  const float* src = a.queries + (size_t)(q < 0 ? 0 : q) * a.d;
  if (a.q16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = q >= 0 && k0 + 4 * i < a.d;
      cp_async16(dst + 4 * i, ok ? src + k0 + 4 * i : a.queries, ok ? 16 : 0);
    }
  } else {
    for (int i = 0; i < 16; ++i) {
      const bool ok = q >= 0 && k0 + i < a.d;
      cp_async4(dst + i, ok ? src + k0 + i : a.queries, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_group2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    leaf_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);                // [kKS][kR]
  float* As = Bs + kKS * kR;                                 // [kG][kAStride]
  // the pass bits: [kR][32] whole bit rows, or [kG][kR] words past 1,024
  // queries
  unsigned* words = reinterpret_cast<unsigned*>(As + kG * kAStride);
  signed char* stage = reinterpret_cast<signed char*>(words + kG * kR);
  //                                                            [kR][kKS]
  int* srid = reinterpret_cast<int*>(stage + kR * kKS);      // [kR]
  float* xn = reinterpret_cast<float*>(srid + kR);           // [kR]
  float* xpart = xn + kR;                                    // [2][kR]
  int* sslot = reinterpret_cast<int*>(xpart + 2 * kR);       // [2][kG]
  int* sq = sslot + 2 * kG;                                  // [2][kG]
  float* sqn = reinterpret_cast<float*>(sq + 2 * kG);        // [2][kG]
  float* sc = sqn + 2 * kG;                                  // [nslices*kKS]
  float* mn = sc + a.nslices * kKS;

  const int n = *a.n_units;
  int u = blockIdx.x;
  if (u >= n) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the thread's 4 x 8 tile: queries wq + qg + 4 i, rows wr + rg * 4 + j
  // and wr + 32 + rg * 4 + j
  const int wq = (warp >> 2) * 16, wr = (warp & 3) * 64;
  const int qg = lane >> 3, rg = lane & 7;
  const int myql = tid >> 3;         // the query this thread stages

  // a unit's queries into buffer nb: slot, query and ||q||^2 of query myql
  auto publish = [&](int nb, int slot) {
    if ((tid & 7) == 0) {
      const int q = slot < 0 ? -1 : slot / a.nl;
      sslot[nb * kG + myql] = slot;
      sq[nb * kG + myql] = q;
      cp_async4(sqn + nb * kG + myql, q < 0 ? a.qnorm : a.qnorm + q,
                q < 0 ? 0 : 4);
    }
  };

  for (int i = tid; i < a.nslices * kKS; i += kThreads) {
    sc[i] = i < a.d ? a.scale[i] : 0.f;
    mn[i] = i < a.d ? a.mean[i] : 0.f;
  }
  Unit e = load_unit(a, u, n);
  int rid = unit_rowid(a, e);
  int slot = unit_slot(a, e, myql);
  int buf = 0;
  publish(buf, slot);
  stage_unit_rows(a, stage, e, 0);
  stage_unit_queries(a, As, slot < 0 ? -1 : slot / a.nl, 0);
  cp_async_commit();
  Unit e1 = load_unit(a, u + gridDim.x, n);
  int rid1 = -1, slot1 = -1;

  float acc[4][8];
  for (;;) {
    const int nq = e.nq;
    float xx[2] = {0.f, 0.f};
    for (int s = 0; s < a.nslices; ++s) {
      cp_async_wait_all();
      __syncthreads();
      if (s == 0) {
        // the unit's pass bits, staged while the unit is computed: each
        // row's bits for every query (one 128-byte row of by_row, 16-byte
        // pieces swizzled by row) where Q <= 1,024, else the word of each
        // of the unit's queries
        srid[tid] = rid;
        if (a.whole_rows) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int src = 4 * k + (lane >> 3), c = lane & 7;
            const int id = __shfl_sync(0xffffffffu, rid, src);
            const int r = warp * 32 + src;
            if (id >= 0 && (id >> 5) < a.W && 4 * c < a.WQ)
              cp_async16(words + r * 32 + ((c ^ ((r >> 2) & 7)) << 2),
                         a.by_row + (size_t)id * a.WQ + 4 * c, 16);
          }
        } else if (rid >= 0 && (rid >> 5) < a.W) {
          const unsigned* row = a.by_row + (size_t)rid * a.WQ;
          for (int ql = 0; ql < nq; ++ql)
            cp_async4(words + ql * kR + tid, row + (sq[buf * kG + ql] >> 5),
                      4);
        }
        cp_async_commit();
      }
      {  // dequantize: thread t turns rows 2 rp, 2 rp + 1, K half kh
        const int rp = ((warp & 3) << 5) | lane, kh = warp >> 2;
        const float4* sc4 =
            reinterpret_cast<const float4*>(sc + s * kKS + 64 * kh);
        const float4* mn4 =
            reinterpret_cast<const float4*>(mn + s * kKS + 64 * kh);
#pragma unroll 2
        for (int p = 0; p < 4; ++p) {
          const int j = 4 * kh + p;
          // each code c + 128 as the low byte of the float 2^23 + (c + 128),
          // less 2^23 + 128: c exactly, at full rate (no int-to-float)
          unsigned w[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 2 * rp + i;
            const int4 v = *reinterpret_cast<const int4*>(
                stage + r * kKS + ((j ^ ((r >> 1) & 7)) << 4));
            w[i][0] = (unsigned)v.x ^ 0x80808080u;
            w[i][1] = (unsigned)v.y ^ 0x80808080u;
            w[i][2] = (unsigned)v.z ^ 0x80808080u;
            w[i][3] = (unsigned)v.w ^ 0x80808080u;
          }
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 s4 = sc4[p * 4 + e4], m4 = mn4[p * 4 + e4];
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
            for (int el = 0; el < 4; ++el) {
              float x[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float c = __int_as_float(__byte_perm(
                                    w[i][e4], 0x4b00u, 0x5440 + el)) -
                                8388736.f;
                x[i] = __fadd_rn(__fmul_rn(c, sv[el]), mv[el]);
                xx[i] = fmaf(x[i], x[i], xx[i]);
              }
              *reinterpret_cast<float2*>(
                  Bs + (64 * kh + 16 * p + 4 * e4 + el) * kR + 2 * rp) =
                  make_float2(x[0], x[1]);
            }
          }
        }
        if (s + 1 == a.nslices)
          *reinterpret_cast<float2*>(xpart + kh * kR + 2 * rp) =
              make_float2(xx[0], xx[1]);
      }
      __syncthreads();
      const bool last = s + 1 == a.nslices;
      // the next step's rows go out while this one is computed
      if (!last) {
        stage_unit_rows(a, stage, e, s + 1);
      } else if (e1.leaf >= 0) {
        stage_unit_rows(a, stage, e1, 0);
      }
      cp_async_commit();
      if (last) {  // the next unit's row id and slot, the unit after it
        rid1 = unit_rowid(a, e1);
        slot1 = unit_slot(a, e1, myql);
      }
      const Unit e2 = last ? load_unit(a, u + 2 * gridDim.x, n) : e1;

      if (wq < nq) {
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        }
        const float* Ap = As + (wq + qg) * kAStride;
        const float* Bp = Bs + wr + rg * 4;
        const int kmax = min(kKS, (a.d - s * kKS + 3) & ~3);
#pragma unroll 2
        for (int k = 0; k < kmax; k += 4) {
          float4 av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] =
                *reinterpret_cast<const float4*>(Ap + 4 * i * kAStride + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 b0 =
                *reinterpret_cast<const float4*>(Bp + (k + kk) * kR);
            const float4 b1 =
                *reinterpret_cast<const float4*>(Bp + (k + kk) * kR + 32);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
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
      if (last)   // each row's ||x||^2: its two K halves, in order
        xn[tid] = xpart[tid] + xpart[kR + tid];
      __syncthreads();  // As is free
      if (!last) {
        stage_unit_queries(a, As, slot < 0 ? -1 : slot / a.nl, s + 1);
      } else if (e1.leaf >= 0) {
        publish(buf ^ 1, slot1);
        stage_unit_queries(a, As, slot1 < 0 ? -1 : slot1 / a.nl, 0);
      }
      cp_async_commit();
      if (last) {
        // epilogue: this unit's scores, each query's along C
        cp_async_wait_group2();     // the words (older than the two above)
        __syncthreads();
        if (wq < nq) {
          float xv[8];
          int rv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = wr + (j >> 2) * 32 + rg * 4 + (j & 3);
            xv[j] = xn[r];
            rv[j] = srid[r];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ql = wq + qg + 4 * i;
            if (ql >= nq) continue;
            const float qv = sqn[buf * kG + ql];
            const int qw = sq[buf * kG + ql] >> 5, qbit = sq[buf * kG + ql] & 31;
            float* orow =
                a.out + (size_t)sslot[buf * kG + ql] * a.C + e.r0;
            const unsigned* wrow = words + ql * kR;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = wr + h * 32 + rg * 4;
              unsigned wv[4];
              if (a.whole_rows) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int r = c + j;
                  wv[j] = words[r * 32 + (((qw >> 2) ^ ((r >> 2) & 7)) << 2) +
                                (qw & 3)];
                }
              } else {
                const uint4 w4 = *reinterpret_cast<const uint4*>(wrow + c);
                wv[0] = w4.x;
                wv[1] = w4.y;
                wv[2] = w4.z;
                wv[3] = w4.w;
              }
              float v[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int jj = h * 4 + j, id = rv[jj];
                const bool ok =
                    id >= 0 && (id >> 5) < a.W && ((wv[j] >> qbit) & 1u);
                v[j] = ok ? (a.metric == 1 ? -acc[i][jj]
                                           : qv + xv[jj] - 2.f * acc[i][jj])
                          : INFINITY;
              }
              if (a.vec_out && e.r0 + c + 3 < a.C) {
                __stcs(reinterpret_cast<float4*>(orow + c),
                       make_float4(v[0], v[1], v[2], v[3]));
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (e.r0 + c + j < a.C) orow[c + j] = v[j];
              }
            }
          }
        }
        if (e1.leaf < 0) return;
        u += gridDim.x;
        e = e1;
        e1 = e2;
        rid = rid1;
        slot = slot1;
        buf ^= 1;
      }
    }
  }
}

size_t scan_smem_bytes(int nslices) {
  return (size_t)kKS * kR * sizeof(float) +
         (size_t)kG * kAStride * sizeof(float) + (size_t)kG * kR * 4 +
         (size_t)kR * kKS + 4 * kR * 4 + 6 * kG * 4 +
         2 * (size_t)nslices * kKS * sizeof(float);
}

// The scratch of one call, in 4-byte words: per bucket a count and a
// cursor, a live flag per (leaf, run), the unit count, ||q||^2 per query,
// the slots, then (16-byte aligned) the units.  -1 when it does not fit an
// int or the slots an int index.
long long scratch_layout(int Q, int nl, int L, int C, long long* off) {
  const long long nslot = (long long)Q * nl;
  const long long nruns = ((long long)C + kR - 1) / kR;
  const long long nchunks = std::min(nslot, (nslot + kG - 1) / kG + L + 1);
  off[0] = 0;                                  // counts [L + 1]
  off[1] = off[0] + L + 1;                     // cursor [L + 1]
  off[2] = off[1] + L + 1;                     // live [L * nruns]
  off[3] = off[2] + (long long)L * nruns;      // n_units [1]
  off[4] = off[3] + 1;                         // qnorm [Q]
  off[5] = off[4] + Q;                         // slots [Q * nl]
  off[6] = (off[5] + nslot + 3) & ~3LL;        // units [4 * nchunks * nruns]
  const long long total = off[6] + 4 * nchunks * nruns;
  return (nslot >= (1LL << 31) || total >= (1LL << 31)) ? -1 : total;
}

// The card's opt-in shared memory per block and SM count, read once: the
// process drives one card.
cudaError_t device_limits(int& max_smem, int& n_sm) {
  static int smem_cached = -1, sm_cached = 0;
  if (smem_cached < 0) {
    int dev = 0, s = 0, m = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&s, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    smem_cached = s;
    sm_cached = m;
  }
  max_smem = smem_cached;
  n_sm = sm_cached;
  return cudaSuccess;
}

}  // namespace

// The 4-byte words of scratch leaf_scan_f32 needs, or -1 when the batch is
// too large for one call.
extern "C" int leaf_scan_scratch_ints(int Q, int nl, int L, int C) {
  long long off[7];
  const long long total = scratch_layout(Q, nl, L, C, off);
  return total < 0 ? -1 : (int)total;
}

// The grouping (counts, live runs, scan, scatter), the bitmaps by row id
// into `by_row` ((32 W, 4 ceil(Q / 128)) words), the +inf fill, then the scan
// over the units; `scratch` holds leaf_scan_scratch_ints(Q, nl, L, C)
// words.  Refuses (cudaErrorInvalidValue) a smaller scratch, a by_row
// that is not 16-byte aligned and a d whose K slices and scale/mean do
// not fit the shared memory of one block.
extern "C" int leaf_scan_f32(const void* queries, const void* leaf_ids,
                             const void* tiles, const void* rowids,
                             const void* scale, const void* mean,
                             const void* bitmaps, void* scratch,
                             void* by_row, void* out, int Q, int nl, int L,
                             int C, int d, int W, int metric,
                             int scratch_ints, void* stream) {
  if (Q == 0 || nl == 0 || C == 0) return 0;
  long long off[7];
  const long long need = scratch_layout(Q, nl, L, C, off);
  if (need < 0 || need > scratch_ints || (size_t)by_row % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int max_smem = 0, n_sm = 0;
  cudaError_t e = device_limits(max_smem, n_sm);
  if (e != cudaSuccess) return (int)e;
  const int nslices = (d + kKS - 1) / kKS;
  const size_t smem = scan_smem_bytes(nslices);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(leaf_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  int* base = static_cast<int*>(scratch);
  int* counts = base + off[0];
  int* cursor = base + off[1];
  int* live = base + off[2];
  int* n_units = base + off[3];
  float* qnorm = reinterpret_cast<float*>(base + off[4]);
  int* slots = base + off[5];
  Unit* units = reinterpret_cast<Unit*>(base + off[6]);
  const int nruns = (C + kR - 1) / kR;
  const long long nslot = (long long)Q * nl;
  const int cap = n_sm * 16;   // blocks of the grid-stride passes

  e = cudaMemsetAsync(counts, 0, (size_t)(L + 1) * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  group_count_kernel<<<std::min((Q + 7) / 8, cap), 256, 0, st>>>(
      (const float*)queries, (const int*)leaf_ids, counts, qnorm, Q, nl, L,
      d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((long long)L * nruns > 0) {
    live_runs_kernel<<<(int)std::min(((long long)L * nruns + 7) / 8,
                                     (long long)cap),
                       256, 0, st>>>((const int*)rowids, counts, live, L, C,
                                     nruns);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  group_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, live, cursor, units,
                                                n_units, L, nruns);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  group_scatter_kernel<<<(int)std::min((nslot + 255) / 256, (long long)cap),
                         256, 0, st>>>((const int*)leaf_ids, cursor, slots,
                                       (int)nslot, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int WQ = (Q + 127) / 128 * 4;   // whole 16-byte pieces a row
  bits_by_row_kernel<<<(W + 31) / 32 * ((WQ + 7) / 8), 256, 0, st>>>(
      (const unsigned*)bitmaps, (unsigned*)by_row, Q, W, WQ);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fill_inf_kernel<<<n_sm * 8, 256, 0, st>>>(
      (float*)out, nslot * C, (size_t)out % 16 == 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  ScanArgs a;
  a.queries = (const float*)queries;
  a.tiles = (const signed char*)tiles;
  a.rowids = (const int*)rowids;
  a.scale = (const float*)scale;
  a.mean = (const float*)mean;
  a.by_row = (const unsigned*)by_row;
  a.units = units;
  a.n_units = n_units;
  a.slots = slots;
  a.qnorm = qnorm;
  a.out = (float*)out;
  a.nl = nl;
  a.C = C;
  a.d = d;
  a.W = W;
  a.WQ = WQ;
  a.whole_rows = WQ <= 32;
  a.nslices = nslices;
  a.metric = metric;
  a.tiles16 = d % 16 == 0 && (size_t)tiles % 16 == 0;
  a.q16 = d % 4 == 0 && (size_t)queries % 16 == 0;
  a.vec_out = C % 4 == 0 && (size_t)out % 16 == 0;
  leaf_scan_kernel<<<n_sm, kThreads, smem, st>>>(a);
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
  int max_smem = 0, n_sm = 0;
  cudaError_t e = device_limits(max_smem, n_sm);
  if (e != cudaSuccess) return (int)e;
  const int nslices = (d + kKS - 1) / kKS;
  const size_t smem = batched_smem_bytes(nslices);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(
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
