// frontier_scan: one graph superstep's candidate scoring + filter probe.
//
// Replaces the Pallas kernels of src/repro/kernels/frontier_scan.py:
//   frontier_scan_f32       <- `frontier_scan_pallas`          (:92)
//   frontier_scan_sq8       <- `frontier_scan_sq8_pallas`      (:164)
//   frontier_scan_excl_f32  <- `frontier_scan_excl_pallas`     (:240)
//   frontier_scan_excl_sq8  <- `frontier_scan_excl_sq8_pallas` (:322)
// For every (query, candidate id) it returns the L2 distance
// ||q||^2 + ||x||^2 - 2 q.x (precomputed ||x||^2) or the negated inner
// product, +inf where the id is -1 padding (or >= n), and the bit
// word[id >> 5] >> (id & 31) & 1 of the query's packed filter bitmap.  The
// SQ8 variants read int8 shadow rows and dequantize in the kernel
// (x = t * scale + mean, ||x||^2 precomputed from the dequantized rows).
// The exclusion variants add the FAVOR keep mask: keep = pass |
// sqrt(e) <= margin * (sqrt(d) + sqrt(tau)) on the +inf-masked distance
// (each value clamped at 0 first), with e the candidate's squared
// exclusion radius, read from row `radius_row[q]` of an (R + F, n) radius
// table, and tau the query's current result-queue tail.  FP32 FMA
// arithmetic, no --use_fast_math:
// sqrtf stays correctly rounded; summation order differs from the plain
// version, so distances agree within allclose(1e-5, 1e-4).
//
// What bounds it on an H100: it is a gather-GEMV, far below the FP32
// ridge point.  Each candidate row (4d bytes f32, d bytes int8) is read
// once with its norm and bitmap word, nothing is reused across candidates,
// and a main-path launch (1,000 queries x 32 or 64 candidates) moves only
// 6-33 MB.  At that size latency bounds it before bytes do: a chain of
// dependent loads (id -> row, norm, word -> store) per candidate, and
// enough rows in flight on every SM to hide ~0.7 us of device-memory
// latency at 3.35 TB/s (~18 KB an SM).
//
// What the design does about it (all four variants):
// - One resident wave.  A warp scores one (query, 32-candidate slab) item;
//   the grid holds no more one-warp blocks than fit on the card at once,
//   and each warp walks items with a grid stride, so no block waits for
//   another to drain.  One-warp blocks (and __launch_bounds__(32)) timed
//   faster than two-warp ones: ptxas schedules the loads differently.
// - No load behind a barrier.  Each lane reads its slice of the query (and
//   for SQ8 of scale and mean) straight into registers; no shared memory,
//   no __syncthreads.  ||q||^2 is reduced once per item, not per candidate.
// - Ids first.  One coalesced load brings the slab's 32 ids, one a lane;
//   each lane then loads its own candidate's norm and bitmap word, and the
//   warp reads the rows (ids broadcast by __shfl_sync) R at a time: 32
//   lanes x one float4 an f32 row at d = 128, 8 lanes x 16 bytes an SQ8
//   row (4 rows a warp instruction).  ptxas interleaves those loads with
//   the products of the rows before them, so for SQ8 each lane first asks
//   L2 for its own candidate's row (one prefetch line at d = 128): all 32
//   rows are requested at once, and the products wait on L2.  (For f32 the
//   prefetch timed slower: 4 lines a row, and the rows set the time.)  A
//   padded id issues no load; a slab of padding only writes +inf / 0.
// - Partial products stay per lane (one per row) and one transposing
//   butterfly of 31 shuffles (7 for SQ8's 8-lane rows) leaves candidate j's
//   dot product in lane j, which completes the distance and stores
//   dist[q, j] and pass[q, j]: coalesced stores.
// Shapes the register layout does not take (d not a multiple of 4 or an
// unaligned pointer, for SQ8 d not a multiple of 16; f32 d > 1536, SQ8
// d > 1024) run a generic kernel with the same item loop and id-first
// loads, scalar row loads four rows at a time, the query through L1.
//
// The exclusion variants (frontier_scan_excl_f32, frontier_scan_excl_sq8)
// are the same three kernels with a template flag, launched the same way.
// What they add to the work is one 4-byte squared radius a candidate: a
// third random 32-byte sector beside the norm and the bitmap word, out of a
// (13, 1M) table on the main path (52 MB, a little over the 50 MB L2), and
// one keep byte out.  So the same latency bounds them, and the design keeps
// the chain as short as the plain scans': each warp reads its query's
// table row and tau at the item's start, beside the ids, so each lane's
// radius load table[row * n + id] issues with its norm and bitmap word
// (id -> {row, norm, word, radius}: two dependent round trips, not four),
// and lane j completes keep[q, j] from its own distance and stores it
// beside dist and pass.  Padding's keep is the rule at d = +inf (with no
// radius loaded): margin * inf bounds every radius only for margin > 0;
// 0 * inf is NaN and a negative margin gives -inf, so keep is then false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 32;  // one warp a block

// The sum over a group of G lanes, in every lane of the group.
template <int G>
__device__ __forceinline__ float group_allsum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Each lane of a group of T lanes holds T partial sums; afterwards lane j of
// the group returns the sum of v[j] over the group (a transposing
// butterfly: T - 1 shuffles for T sums).  Step S halves the sums a lane
// holds; one template instance a step, so every index is a constant and v
// stays in registers.
template <int T, int S>
__device__ __forceinline__ void transpose_step(float (&v)[T], int lane) {
  if constexpr (S >= 1) {
    const bool upper = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float send = upper ? v[i] : v[i + S];
      const float keep = upper ? v[i + S] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, S);
    }
    transpose_step<T, S / 2>(v, lane);
  }
}

template <int T>
__device__ __forceinline__ float transpose_sum(float (&v)[T], int lane) {
  transpose_step<T, T / 2>(v, lane);
  return v[0];
}

// Asks L2 for the `bytes` of one row, a 128-byte line at a time, without
// waiting for them and without a register to hold them.
__device__ __forceinline__ void prefetch_row(const char* row, int bytes) {
  for (int off = 0; off < bytes; off += 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + off));
}

struct Scan {
  const float* queries;  // (Q, d)
  const void* rows;      // (n, d) f32 or int8
  const float* scale;    // (d,) SQ8 only
  const float* mean;     // (d,) SQ8 only
  const float* norms;    // (n,)
  const int* ids;        // (Q, C)
  const int* bitmaps;    // (Q, W)
  float* dist;           // (Q, C) out
  unsigned char* pass;   // (Q, C) out
  int Q, C, d, W, n, metric;
};

// The exclusion variants' arguments, a struct of their own: with these
// fields in Scan, ptxas scheduled the plain SQ8 kernel's row loads one
// after another (on an H100, 0.0058 -> 0.0082 ms at (1000, 32, 128)).
struct ExclScan : Scan {
  const float* table;      // (R + F, n) squared exclusion radii
  const int* radius_row;   // (Q,) the table row each query reads
  const float* tau;        // (Q,) the query's result-queue tail
  unsigned char* keep;     // (Q, C) out
  float margin;
};

template <bool EX>
using Args = std::conditional_t<EX, ExclScan, Scan>;

// One warp's (query, 32-candidate slab) item: lane j holds candidate j's
// id, whether it is a row of the store, its norm and its bitmap word; with
// exclusion also its squared radius (0 for padding) and the query's tau.
struct Slab {
  int qi, c, id;
  size_t o;
  bool valid;
  unsigned live;  // ballot of valid
  float norm;
  unsigned word;
  float e, tau;
};

// The FAVOR keep rule on one candidate, in ref.excl_keep_mask's order:
// pass | sqrt(e) <= margin * (sqrt(d) + sqrt(tau)), each clamped at 0.
__device__ __forceinline__ unsigned char keep_rule(float dist, float e,
                                                   float tau, float margin,
                                                   unsigned char ok) {
  const float bound =
      margin * (sqrtf(fmaxf(dist, 0.f)) + sqrtf(fmaxf(tau, 0.f)));
  return ok | (unsigned char)(sqrtf(fmaxf(e, 0.f)) <= bound);
}

// Loads the slab's ids (one a lane), with EX the query's table row and tau
// beside them, then each lane's norm, bitmap word and (EX) radius.  Returns
// false, after writing +inf / 0 (and keep by the rule), for a slab of
// padding only.
template <bool EX>
__device__ __forceinline__ bool slab_head(const Args<EX>& a, long long item,
                                          int slabs, int lane, Slab& s) {
  s.qi = (int)(item / slabs);
  s.c = (int)(item - (long long)s.qi * slabs) * 32 + lane;
  s.o = (size_t)s.qi * a.C + s.c;
  int row = 0;
  if constexpr (EX) {
    row = __ldg(a.radius_row + s.qi);
    s.tau = __ldg(a.tau + s.qi);
  }
  s.id = s.c < a.C ? __ldg(a.ids + s.o) : -1;
  s.valid = (unsigned)s.id < (unsigned)a.n;
  s.live = __ballot_sync(kFull, s.valid);
  s.e = 0.f;
  if (s.live == 0u) {
    if (s.c < a.C) {
      a.dist[s.o] = INFINITY;
      a.pass[s.o] = 0;
      if constexpr (EX)
        a.keep[s.o] = keep_rule(INFINITY, s.e, s.tau, a.margin, 0);
    }
    return false;
  }
  s.norm = 0.f;
  s.word = 0u;
  if (s.valid) {
    if (a.metric == 0) s.norm = __ldg(a.norms + s.id);
    s.word = (unsigned)__ldg(a.bitmaps + (size_t)s.qi * a.W + (s.id >> 5));
    if constexpr (EX) s.e = __ldg(a.table + (size_t)row * a.n + s.id);
  }
  return true;
}

// Lane j completes candidate j's distance from its dot product and stores
// it, its pass flag and (EX) its keep flag: coalesced stores.
template <bool EX>
__device__ __forceinline__ void slab_store(const Args<EX>& a, const Slab& s,
                                           float ip, float qq) {
  if (s.c >= a.C) return;
  const float dist = !s.valid ? INFINITY
                              : (a.metric == 1 ? -ip : qq + s.norm - 2.f * ip);
  const unsigned char ok =
      s.valid ? (unsigned char)((s.word >> (s.id & 31)) & 1u) : 0;
  a.dist[s.o] = dist;
  a.pass[s.o] = ok;
  if constexpr (EX) a.keep[s.o] = keep_rule(dist, s.e, s.tau, a.margin, ok);
}

__device__ __forceinline__ long long first_item() {
  return ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long item_stride() {
  return ((long long)gridDim.x * blockDim.x) >> 5;
}

// f32 rows, d % 4 == 0, 16-byte aligned: lane holds float4s lane + 32 k
// (k < K) of the query and of each row; the source loads R rows a step
// (how many stay in flight is ptxas's choice).
template <bool EX, int K, int R>
__global__ void __launch_bounds__(kBlock) scan_f32_kernel(Args<EX> a) {
  const int lane = threadIdx.x & 31;
  const int slabs = (a.C + 31) >> 5;
  const long long items = (long long)a.Q * slabs;
  const int nv = a.d >> 2;
  const float4* rows4 = reinterpret_cast<const float4*>(a.rows);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long it = first_item(); it < items; it += item_stride()) {
    const int qi = (int)(it / slabs);
    const float4* q4 =
        reinterpret_cast<const float4*>(a.queries + (size_t)qi * a.d);
    float4 qv[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      qv[k] = lane + 32 * k < nv ? __ldg(q4 + lane + 32 * k) : zero;
    Slab s;
    if (!slab_head<EX>(a, it, slabs, lane, s)) continue;
    float p[32];
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += R) {
      float4 x[R][K];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int rid = __shfl_sync(kFull, s.id, r0 + u);
        const bool on = (s.live >> (r0 + u)) & 1u;
        const float4* xr = rows4 + (size_t)(on ? rid : 0) * nv;
#pragma unroll
        for (int k = 0; k < K; ++k)
          x[u][k] = on && lane + 32 * k < nv ? __ldg(xr + lane + 32 * k)
                                             : zero;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc = fmaf(x[u][k].x, qv[k].x, acc);
          acc = fmaf(x[u][k].y, qv[k].y, acc);
          acc = fmaf(x[u][k].z, qv[k].z, acc);
          acc = fmaf(x[u][k].w, qv[k].w, acc);
        }
        p[r0 + u] = acc;
      }
    }
    float qq = 0.f;
    if (a.metric == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        qq += qv[k].x * qv[k].x + qv[k].y * qv[k].y + qv[k].z * qv[k].z +
              qv[k].w * qv[k].w;
      qq = group_allsum<32>(qq);
    }
    slab_store<EX>(a, s, transpose_sum<32>(p, lane), qq);
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(p4 + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// SQ8 rows, d % 16 == 0, 16-byte aligned: a row is d / 16 chunks of 16
// bytes, read by a group of G lanes (lane j of the group takes chunks
// j + G k, k < K), so one warp instruction reads 32 / G rows.  Group g
// scores rows g G .. g G + G - 1, one a step, R steps of loads at a time;
// the lane's query, scale and mean slices live in registers.
template <bool EX, int G, int K, int R>
__global__ void __launch_bounds__(kBlock) scan_sq8_kernel(Args<EX> a) {
  const int lane = threadIdx.x & 31;
  const int g = lane / G, j = lane % G;
  const int slabs = (a.C + 31) >> 5;
  const long long items = (long long)a.Q * slabs;
  const int nch = a.d >> 4;
  const int4* rows16 = reinterpret_cast<const int4*>(a.rows);
  float sv[K][16], mv[K][16];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = j + G * k;
    if (ch < nch) {
      load16(a.scale + 16 * ch, sv[k]);
      load16(a.mean + 16 * ch, mv[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) sv[k][i] = mv[k][i] = 0.f;
    }
  }
  for (long long it = first_item(); it < items; it += item_stride()) {
    const int qi = (int)(it / slabs);
    float qv[K][16];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ch = j + G * k;
      if (ch < nch) {
        load16(a.queries + (size_t)qi * a.d + 16 * ch, qv[k]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) qv[k][i] = 0.f;
      }
    }
    Slab s;
    if (!slab_head<EX>(a, it, slabs, lane, s)) continue;
    // each lane asks L2 for its own candidate's row now; the products'
    // loads below then wait on L2, not on device memory
    if (s.valid)
      prefetch_row(static_cast<const char*>(a.rows) + (size_t)s.id * a.d,
                   a.d);
    float p[G];
#pragma unroll
    for (int t0 = 0; t0 < G; t0 += R) {
      int4 x[R][K];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int row = g * G + t0 + u;
        const int rid = __shfl_sync(kFull, s.id, row);
        const bool on = (s.live >> row) & 1u;
        const int4* xr = rows16 + (size_t)(on ? rid : 0) * nch;
#pragma unroll
        for (int k = 0; k < K; ++k)
          x[u][k] = on && j + G * k < nch ? __ldg(xr + j + G * k)
                                          : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int w[4] = {x[u][k].x, x[u][k].y, x[u][k].z, x[u][k].w};
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float t = (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xff);
            acc = fmaf(fmaf(t, sv[k][i], mv[k][i]), qv[k][i], acc);
          }
        }
        p[t0 + u] = acc;
      }
    }
    float qq = 0.f;
    if (a.metric == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 16; ++i) qq = fmaf(qv[k][i], qv[k][i], qq);
      qq = group_allsum<G>(qq);
    }
    // lane j of group g now holds row g G + j, which is its own lane
    slab_store<EX>(a, s, transpose_sum<G>(p, lane), qq);
  }
}

// Any d, any alignment: scalar row loads, four rows at a time over the
// slab's live rows, the query (and scale, mean) read through L1.
template <bool EX, bool SQ8>
__global__ void __launch_bounds__(kBlock) scan_generic_kernel(Args<EX> a) {
  const int lane = threadIdx.x & 31;
  const int slabs = (a.C + 31) >> 5;
  const long long items = (long long)a.Q * slabs;
  const int d = a.d;
  for (long long it = first_item(); it < items; it += item_stride()) {
    Slab s;
    if (!slab_head<EX>(a, it, slabs, lane, s)) continue;
    const float* qrow = a.queries + (size_t)s.qi * d;
    float mine = 0.f;
    unsigned rem = s.live;
    while (rem) {
      int r[4];
      size_t base[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        r[u] = __ffs(rem) - 1;  // -1 once no row is left
        rem &= rem - 1u;
        const int rid = __shfl_sync(kFull, s.id, r[u] & 31);
        base[u] = (size_t)(r[u] >= 0 ? rid : 0) * d;
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = lane; i < d; i += 32) {
        const float b = __ldg(qrow + i);
        float sc = 0.f, mn = 0.f;
        if (SQ8) {
          sc = __ldg(a.scale + i);
          mn = __ldg(a.mean + i);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r[u] < 0) continue;
          float x;
          if (SQ8) {
            const int8_t* t = reinterpret_cast<const int8_t*>(a.rows);
            x = fmaf((float)__ldg(t + base[u] + i), sc, mn);
          } else {
            x = __ldg(reinterpret_cast<const float*>(a.rows) + base[u] + i);
          }
          acc[u] = fmaf(x, b, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = group_allsum<32>(acc[u]);
        if (lane == r[u]) mine = v;
      }
    }
    float qq = 0.f;
    if (a.metric == 0) {
      for (int i = lane; i < d; i += 32) {
        const float b = __ldg(qrow + i);
        qq = fmaf(b, b, qq);
      }
      qq = group_allsum<32>(qq);
    }
    slab_store<EX>(a, s, mine, qq);
  }
}

int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Resident one-warp blocks an SM holds of `kernel`, asked once per kernel.
int blocks_per_sm(const void* kernel) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> seen;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kv : seen)
    if (kv.first == kernel) return kv.second;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  seen.emplace_back(kernel, per_sm > 0 ? per_sm : 1);
  return seen.back().second;
}

// One resident wave: a one-warp block an item, at most as many blocks as
// fit on the card at once (each warp then walks items by stride).
template <class A>
int launch_items(void (*kernel)(A), const A& a, void* stream) {
  if (a.Q == 0 || a.C == 0) return 0;
  long long blocks = (long long)a.Q * ((a.C + 31) / 32);
  const long long wave = (long long)blocks_per_sm((const void*)kernel) *
                         sm_count();
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The register-layout f32 kernel for d, else the generic one.
template <bool EX>
int launch_f32(const Args<EX>& a, int vec4, void* stream) {
  const int nv = a.d / 4;
  if (vec4 && aligned16(a.queries) && nv <= 384) {
    if (nv <= 32) return launch_items(scan_f32_kernel<EX, 1, 8>, a, stream);
    if (nv <= 64) return launch_items(scan_f32_kernel<EX, 2, 4>, a, stream);
    if (nv <= 128) return launch_items(scan_f32_kernel<EX, 4, 2>, a, stream);
    if (nv <= 256) return launch_items(scan_f32_kernel<EX, 8, 1>, a, stream);
    return launch_items(scan_f32_kernel<EX, 12, 1>, a, stream);
  }
  return launch_items(scan_generic_kernel<EX, false>, a, stream);
}

// The 16-byte SQ8 kernel for d, else the generic one.
template <bool EX>
int launch_sq8(const Args<EX>& a, int vec4, void* stream) {
  const int nch = a.d / 16;
  if (vec4 && a.d % 16 == 0 && nch <= 64 && aligned16(a.queries) &&
      aligned16(a.rows) && aligned16(a.scale) && aligned16(a.mean)) {
    if (nch <= 8) return launch_items(scan_sq8_kernel<EX, 8, 1, 8>, a, stream);
    if (nch <= 16)
      return launch_items(scan_sq8_kernel<EX, 16, 1, 8>, a, stream);
    if (nch <= 32)
      return launch_items(scan_sq8_kernel<EX, 32, 1, 8>, a, stream);
    return launch_items(scan_sq8_kernel<EX, 32, 2, 4>, a, stream);
  }
  return launch_items(scan_generic_kernel<EX, true>, a, stream);
}

}  // namespace

// vec4: d % 4 == 0 and the rows 16-byte aligned (the wrapper's flag).
extern "C" int frontier_scan_f32(const void* queries, const void* rows,
                                 const void* norms, const void* ids,
                                 const void* bitmaps, void* dist, void* pass,
                                 int Q, int C, int d, int W, int n,
                                 int metric, int vec4, void* stream) {
  const Scan a = {(const float*)queries, rows, nullptr, nullptr,
                  (const float*)norms, (const int*)ids, (const int*)bitmaps,
                  (float*)dist, (unsigned char*)pass, Q, C, d, W, n, metric};
  return launch_f32<false>(a, vec4, stream);
}

// vec4: d % 4 == 0 and the rows 4-byte aligned (the wrapper's flag); the
// 16-byte route also needs d % 16 == 0 and every pointer 16-byte aligned.
extern "C" int frontier_scan_sq8(const void* queries, const void* qrows,
                                 const void* scale, const void* mean,
                                 const void* norms, const void* ids,
                                 const void* bitmaps, void* dist, void* pass,
                                 int Q, int C, int d, int W, int n,
                                 int metric, int vec4, void* stream) {
  const Scan a = {(const float*)queries, qrows, (const float*)scale,
                  (const float*)mean, (const float*)norms, (const int*)ids,
                  (const int*)bitmaps, (float*)dist, (unsigned char*)pass,
                  Q, C, d, W, n, metric};
  return launch_sq8<false>(a, vec4, stream);
}

extern "C" int frontier_scan_excl_f32(const void* queries, const void* rows,
                                      const void* norms, const void* ids,
                                      const void* bitmaps, const void* table,
                                      const void* radius_row, const void* tau,
                                      void* dist, void* pass, void* keep,
                                      float margin, int Q, int C, int d,
                                      int W, int n, int metric, int vec4,
                                      void* stream) {
  const ExclScan a = {{(const float*)queries, rows, nullptr, nullptr,
                       (const float*)norms, (const int*)ids,
                       (const int*)bitmaps, (float*)dist, (unsigned char*)pass,
                       Q, C, d, W, n, metric},
                      (const float*)table, (const int*)radius_row,
                      (const float*)tau, (unsigned char*)keep, margin};
  return launch_f32<true>(a, vec4, stream);
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
  const ExclScan a = {{(const float*)queries, qrows, (const float*)scale,
                       (const float*)mean, (const float*)norms,
                       (const int*)ids, (const int*)bitmaps, (float*)dist,
                       (unsigned char*)pass, Q, C, d, W, n, metric},
                      (const float*)table, (const int*)radius_row,
                      (const float*)tau, (unsigned char*)keep, margin};
  return launch_sq8<true>(a, vec4, stream);
}
