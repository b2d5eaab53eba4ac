// flash_attention: forward online-softmax attention over (B, T, H, hd) queries
// and (B, S, KV, hd) keys and values, optional causal masking, grouped-query
// heads (G = H / KV query heads share one kv head).
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (called through
// `flash_attention_pallas`): the encoder prefill runs it in every layer when
// the config sets `pallas_flash`.  It computes what that kernel computes:
// the online softmax over the keys, masked scores at the finite -1e30, the
// causal rule kpos <= qpos with positions counted from 0, and the output
// acc / max(l, 1e-20) in q's type.
//
// What bounds it on an H100: operations.  The work is 4 B H T S hd flops
// (q.k and p.v); at the encoder's shape (B = 2, T = S = 8192, H = 16,
// hd = 80, bf16) that is 6.9e11 flops, 0.69 ms at the 989 TFLOP/s of the
// bf16 tensor cores, against 168 MB of Q, K, V and O, 0.05 ms of memory
// traffic.
//
// Two routes, chosen by the wrapper from the dtype and the head width alone:
//
// * `flash_attention_wgmma` (bf16, hd 64, 80 or 128): the tensor-core kernel.
//   One block owns one (batch, kv head, tile of 128 rows), a row being a
//   (position, head) pair of that kv head, so grouped-query attention needs
//   no regrouping copy; each of its two warpgroups owns 64 rows.  Q is
//   staged in shared memory once (16-byte cp.async copies).  K and V tiles
//   of 64 keys are staged as bf16 by TMA in a ring of two stages: thread 0
//   issues the copies of tile t + 1 on an mbarrier as tile t's products
//   start, so loads overlap the math; one block barrier a tile frees a
//   stage.  S = Q.K^T is `wgmma.mma_async` m64n64k16 with both operands in
//   shared memory and an f32 accumulator; the bf16 products are exact, and
//   1/sqrt(hd) (rounded to f32, times log2 e) scales the f32 scores, not
//   q, so q is rounded once only.  The online softmax runs on the
//   accumulator fragment in registers, in f32, with exp2.  P is rounded to
//   bf16 in place (the accumulator layout of the first product is the
//   register A-fragment layout of the second) and O += P.V is a second
//   wgmma with V an MN-major (transposed) operand in shared memory.  The row
//   sum l adds the bf16-rounded probabilities, the weights that actually
//   enter P.V, so the output stays a normalised average.
//   Rows of 80 bf16 are 160 bytes, no multiple of the 128-byte swizzle
//   atom, so each tile is cut into panels: 64 columns under the 128-byte
//   swizzle and, at hd 80, 16 columns under the 32-byte swizzle, each its
//   own TMA box and its own wgmma descriptors (S takes four k-steps in the
//   first panel and one in the second; P.V one m64n64 and one m64n16
//   product).  A key row then arrives as two requests of 128 and 32 bytes;
//   the no-swizzle layout would need ten of 16 bytes, and requests that
//   small bound the staging on an H100 (2.3-2.5 ms at the encoder's shape
//   with no math at all).  The swizzles keep wgmma's shared-memory reads
//   free of bank conflicts.  At hd 80 a thread holds 127 registers and a
//   block 62,480 bytes of shared memory, so two blocks (four warpgroups)
//   share an SM and one's softmax overlaps another's products.  A causal
//   block stops at the tile of its last row's position, and only tiles
//   that cross the diagonal or the end of S are masked (TMA zero-fills
//   keys past S).  A run repeats bit for bit.  Rounding P to bf16 moves the outputs by a relative L2
//   error of about 2e-3 against the f32-probability plain version, bf16
//   output rounding included (the tolerance is derived in
//   tests/test_torch_cuda.py and chip_smoke.py).  The tensor maps are
//   encoded per call with the driver's cuTensorMapEncodeTiled, fetched
//   through cudaGetDriverEntryPoint, so nothing links the driver library.
//
// * `flash_attention` (f32 at any width up to 256, bf16 at the widths the
//   tensor-core kernel does not take): the FP32 FMA template, which keeps
//   every product in FP32 FMA so the f32 route holds a 1e-5 tolerance.  One
//   block owns one (batch, kv head, tile of BQ query positions) and all G
//   query heads of that kv head, one thread per (position, head) row: the
//   thread holds its scaled q row and its f32 accumulator in registers.  The
//   block stages BK keys and values at a time in shared memory, converted to
//   f32; each shared load is a broadcast feeding four FMAs.  The online
//   softmax advances SUB keys at a time with expf, in a fixed order, so a run
//   repeats bit for bit.  A causal block stops at the last key its last row
//   can see.  The head dimension is padded in shared memory to a compiled
//   width HDP (32, 64, 80, 128 or 256) with zeros.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_ROWS = 256;    // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HDP>
struct Tile {
  // keys staged per round: 32 up to hd 128, 16 above (<= 32 KB of f32)
  static constexpr int BK = HDP <= 128 ? 32 : 16;
  // keys per online-softmax step: fewer for wide heads, whose q row and
  // accumulator already fill the registers (and whose unrolled steps
  // would make the build slow)
  static constexpr int SUB = HDP <= 80 ? 16 : (HDP <= 128 ? 8 : 4);
};

template <typename T, int HDP, bool CAUSAL>
__global__ void __launch_bounds__(MAX_ROWS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tq,
                       int S, int H, int KV, int hd, int G, int BQ,
                       float scale) {
  constexpr int BK = Tile<HDP>::BK, SUB = Tile<HDP>::SUB;
  __shared__ __align__(16) float ks[BK * HDP];
  __shared__ __align__(16) float vs[BK * HDP];

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int pos = q0 + tid / G;
  const int head = kvh * G + tid % G;
  const bool active = pos < Tq;

  float qr[HDP], acc[HDP];
  const T* qrow = q + (((size_t)b * Tq + (active ? pos : 0)) * H + head) * hd;
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    qr[d] = (active && d < hd) ? to_f32(qrow[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // the keys this block's rows can see: all of them, or up to its last row
  const int kend = CAUSAL ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * HDP; e += nthreads) {
      const int j = e / HDP, d = e - j * HDP;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S && d < hd) {
        const size_t off = (((size_t)b * S + s) * KV + kvh) * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += SUB) {
      float sc[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) sc[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; d += 4) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&ks[(j0 + jj) * HDP + d]);
          sc[jj] = fmaf(qr[d], kk.x, sc[jj]);
          sc[jj] = fmaf(qr[d + 1], kk.y, sc[jj]);
          sc[jj] = fmaf(qr[d + 2], kk.z, sc[jj]);
          sc[jj] = fmaf(qr[d + 3], kk.w, sc[jj]);
        }
      }
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int s = k0 + j0 + jj;
        const bool valid = s < S && (!CAUSAL || s <= pos);
        sc[jj] = valid ? sc[jj] : NEG_INF;
        mx = fmaxf(mx, sc[jj]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(sc[jj] - mx);
        l += p;
#pragma unroll
        for (int d = 0; d < HDP; d += 4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(j0 + jj) * HDP + d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = mx;
    }
  }
  if (!active) return;
  const float denom = fmaxf(l, 1e-20f);
  T* orow = out + (((size_t)b * Tq + pos) * H + head) * hd;
#pragma unroll
  for (int d = 0; d < HDP; ++d)
    if (d < hd) store(&orow[d], acc[d] / denom);
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int S, int H, int KV, int hd, int causal,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int BQ = G >= MAX_ROWS ? 1 : (64 * G <= MAX_ROWS ? 64 : MAX_ROWS / G);
  dim3 grid((Tq + BQ - 1) / BQ, KV, B);
  dim3 block(BQ * G);
  const float scale = (float)(1.0 / sqrt((double)hd));
  if (causal)
    flash_attention_kernel<T, HDP, true><<<grid, block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Tq, S, H, KV, hd, G,
        BQ, scale);
  else
    flash_attention_kernel<T, HDP, false><<<grid, block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Tq, S, H, KV, hd, G,
        BQ, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Tq, int S, int H, int KV, int hd, int causal,
                     cudaStream_t st) {
  if (hd <= 32) return launch<T, 32>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st);
  if (hd <= 80) return launch<T, 80>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st);
  if (hd <= 128) return launch<T, 128>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st);
  return launch<T, 256>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st);
}

}  // namespace

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;
constexpr int NWG = 2;                       // warpgroups a block
constexpr int THREADS = NWG * WG_THREADS;
constexpr int BM = 64 * NWG;                 // (position, head) rows a block
constexpr int BK = 64;                       // keys a stage
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile's columns are cut into panels, each its own swizzled region: 64
// columns (128-byte rows) under the 128-byte swizzle, and at hd 80 a last
// panel of 16 columns (32-byte rows) under the 32-byte swizzle.  An
// (R, HD) tile holds panel p at p R 128 bytes, the 16-wide panel after the
// 64-wide ones; within a panel row r's 16-byte chunk c sits at chunk
// c ^ (r % 8) (128-byte swizzle) or c ^ ((r / 4) % 2) (32-byte swizzle),
// as TMA writes them.
template <int HD>
struct Tile {
  static constexpr int P64 = HD / 64;        // 64-wide panels
  static constexpr int TAIL = HD % 64;       // 0 or a 16-wide panel
  static_assert(TAIL == 0 || TAIL == 16, "head width 64, 80 or 128");
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;          // one K or V tile
  // + 1024 to align the base to the 128-byte swizzle's 1,024-byte atom
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 8 * STAGES +
                              1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory matrix descriptor of a swizzled layout: `sbo` the bytes
// between 8-row groups, layout 1 the 128-byte swizzle, 3 the 32-byte one
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo,
                                         uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
constexpr uint32_t SW128 = 1, SW32 = 3;

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// the generic-proxy writes of cp.async, made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a (cols, 1, BK, 1) box of a (HD, KV, S, B) tensor into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int kvh,
                                         int key, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(kvh),
      "r"(key), "r"(b)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses to an async product's registers
// (its accumulator, its A fragment) across the product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(d[i][u])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16, shared) . B (N x 16, shared), both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N, f32) += A (64 x 16, registers) . B (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const bf16* __restrict__ q,
                             bf16* __restrict__ out, int Tq, int S, int H,
                             int KV, int G, float scale_log2,
                             const __grid_constant__ CUtensorMap k64,
                             const __grid_constant__ CUtensorMap k16,
                             const __grid_constant__ CUtensorMap v64,
                             const __grid_constant__ CUtensorMap v16) {
  using C = Tile<HD>;
  constexpr int P64 = C::P64, TAIL = C::TAIL, KVB = C::KV_BYTES;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t skv = sq + C::Q_BYTES;  // stage s: K at skv + 2 s KVB, V after
  const uint32_t bars = skv + STAGES * 2 * KVB;    // one mbarrier a stage

  const int tid = threadIdx.x;
  const int wgi = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32;
  const int lane = tid % 32;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rows = Tq * G;
  const int row0 = blockIdx.x * BM;
  const int last = min(row0 + BM, rows) - 1;
  const int kend = CAUSAL ? min(S, last / G + 1) : S;
  const int ntiles = (kend + BK - 1) / BK;

  // Q, once: 16-byte cp.async copies into the swizzled panels
  for (int e = tid; e < BM * HD / 8; e += THREADS) {
    const int r = e / (HD / 8), c = e % (HD / 8);
    const int R = row0 + r;
    const bf16* src =
        R < rows ? q + (((size_t)b * Tq + R / G) * H + kvh * G + R % G) * HD +
                       c * 8
                 : q;
    const uint32_t dst =
        c < 8 * P64
            ? sq + (c / 8) * BM * 128 + r * 128 + (((c % 8) ^ (r & 7)) << 4)
            : sq + P64 * BM * 128 + r * 32 + (((c % 8) ^ ((r >> 2) & 1)) << 4);
    cp_async16(dst, src, R < rows);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // K and V tiles by TMA, one thread issuing, an mbarrier a stage
  auto issue = [&](int tile, int st) {
    const uint32_t bar = bars + 8 * st, sk = skv + st * 2 * KVB;
    const int key = tile * BK;
    mbar_expect_tx(bar, 2 * KVB);
#pragma unroll
    for (int p = 0; p < P64; ++p) {
      tma_load(sk + p * BK * 128, &k64, bar, 64 * p, kvh, key, b);
      tma_load(sk + KVB + p * BK * 128, &v64, bar, 64 * p, kvh, key, b);
    }
    if constexpr (TAIL != 0) {
      tma_load(sk + P64 * BK * 128, &k16, bar, 64 * P64, kvh, key, b);
      tma_load(sk + KVB + P64 * BK * 128, &v16, bar, 64 * P64, kvh, key, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < STAGES - 1 && st < ntiles; ++st) issue(st, st);
  }

  // this thread's two rows of the accumulators: r and r + 8 of its
  // warpgroup's 64
  const int wrow0 = row0 + wgi * 64;
  const int ra = wrow0 + warp * 16 + lane / 4, rb = ra + 8;
  const int pos_a = ra / G, pos_b = rb / G;
  const int pos_min = wrow0 / G;      // the warpgroup's first position
  const uint32_t sqw = sq + wgi * 64 * 128;          // its rows, panel 0
  const uint32_t sqt = sq + P64 * BM * 128 + wgi * 64 * 32;   // 16-wide

  float o[P64][32], ot[TAIL ? 8 : 1];  // the 64-wide panels, the 16-wide
#pragma unroll
  for (int p = 0; p < P64; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < (TAIL ? 8 : 1); ++i) ot[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();           // Q is in; every thread is done with t - 1
    if (tid == 0 && t + STAGES - 1 < ntiles)
      issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    mbar_wait(bars + 8 * (t % STAGES), (t / STAGES) & 1);
    const uint32_t sk = skv + (t % STAGES) * 2 * KVB, sv = sk + KVB;

    // S = Q . K^T, f32: four k-steps of 16 columns a 64-wide panel (the
    // start moves 32 bytes within the swizzled rows), one for the 16-wide
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P64; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss<BK>(s, desc(sqw + p * BM * 128 + 32 * j, 1024, SW128),
                     desc(sk + p * BK * 128 + 32 * j, 1024, SW128),
                     p + j > 0);
    if constexpr (TAIL != 0)
      wgmma_ss<BK>(s, desc(sqt, 256, SW32),
                   desc(sk + P64 * BK * 128, 256, SW32), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // online softmax in the log2 domain: element i of the fragment is row
    // (i >> 1) & 1 (r or r + 8), key 8 (i >> 2) + 2 (lane % 4) + (i & 1);
    // the row maximum is taken on the raw scores (the scale is positive),
    // and exp2(s scale log2e - m) is one FMA and one exp2
    const int k0 = t * BK;
    const bool edge = k0 + BK > S || (CAUSAL && k0 + BK - 1 > pos_min);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      if (edge) {
        const int key = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (key >= S || (CAUSAL && key > (h ? pos_b : pos_a))) s[i] = NEG;
      }
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mnew = fmaxf(m[h], mx[h] * scale_log2);
      corr[h] = exp2_ftz(m[h] - mnew);
      m[h] = mnew;
    }
    // P in bf16, in the A-fragment order of m64nNk16: per 16 keys j,
    // a0 = (r, keys 2q, 2q + 1), a1 = (r + 8, same), a2 = (r, those + 8),
    // a3 = (r + 8, those + 8)
    uint32_t pf[BK / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 8 * j + 2 * u, h = u & 1;
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            exp2_ftz(fmaf(s[i], scale_log2, -m[h])),
            exp2_ftz(fmaf(s[i + 1], scale_log2, -m[h])));
        ls[h] += __low2float(pr) + __high2float(pr);
        pf[j][u] = *reinterpret_cast<const uint32_t*>(&pr);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
    for (int p = 0; p < P64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < (TAIL ? 8 : 1); ++i) ot[i] *= corr[(i >> 1) & 1];

    // O += P . V, a product a panel: V MN-major, 16 keys (two 8-row
    // groups) a k-step
#pragma unroll
    for (int p = 0; p < P64; ++p) fence_regs(o[p]);
    fence_regs(ot);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P64; ++p)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb<64>(o[p], pf[j],
                        desc(sv + p * BK * 128 + j * 2048, 1024, SW128));
    if constexpr (TAIL != 0) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb<16>(ot, pf[j],
                        desc(sv + P64 * BK * 128 + j * 512, 256, SW32));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int p = 0; p < P64; ++p) fence_regs(o[p]);
    fence_regs(ot);
    fence_regs(pf);
  }

  // the quad of threads sharing a row adds its partial sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = h ? rb : ra;
    if (R >= rows) continue;
    const float den = fmaxf(l[h], 1e-20f);
    bf16* orow =
        out + (((size_t)b * Tq + R / G) * H + kvh * G + R % G) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int p = c / 8, i = (c % 8) * 4 + 2 * h;
      const int pp = p < P64 ? p : 0, it = TAIL ? i & 7 : 0;
      const float x0 = p < P64 ? o[pp][i] : ot[it];
      const float x1 = p < P64 ? o[pp][i + 1] : ot[TAIL ? it + 1 : 0];
      *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(x0 / den, x1 / den);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, through the runtime (nothing links the
// driver library); nullptr when the driver lacks it.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K or V (B, S, KV, hd) as the 4-D tensor (hd, KV, S, B); a box of (cols,
// 1, BK, 1) lands as BK rows of `cols` columns, swizzled: 128 bytes for 64
// columns, 32 bytes for 16.  Rows past S are zero-filled.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int S,
                       int KV, int hd, int cols) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)KV * hd * 2,
                                 (cuuint64_t)S * KV * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int S, int H, int KV, cudaStream_t st) {
  CUtensorMap k64, k16, v64, v16;
  cudaError_t e = tensor_map(&k64, k, B, S, KV, HD, 64);
  if (e == cudaSuccess) e = tensor_map(&v64, v, B, S, KV, HD, 64);
  if (e == cudaSuccess) e = tensor_map(&k16, k, B, S, KV, HD, 16);
  if (e == cudaSuccess) e = tensor_map(&v16, v, B, S, KV, HD, 16);
  if (e != cudaSuccess) return e;
  auto kernel = flash_attention_wgmma_kernel<HD, CAUSAL>;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<HD>::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / KV;
  dim3 grid((Tq * G + BM - 1) / BM, KV, B);
  const float scale_log2 =
      (float)(1.0 / sqrt((double)HD)) * 1.4426950408889634f;
  kernel<<<grid, THREADS, Tile<HD>::SMEM, st>>>(
      (const bf16*)q, (bf16*)out, Tq, S, H, KV, G, scale_log2, k64, k16, v64,
      v16);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Tq, int S, int H, int KV, int causal,
                     cudaStream_t st) {
  return causal ? launch<HD, true>(q, k, v, out, B, Tq, S, H, KV, st)
                : launch<HD, false>(q, k, v, out, B, Tq, S, H, KV, st);
}

}  // namespace wg

// The FP32 FMA route.  dtype: 0 float32, 1 bfloat16.  The wrapper checks
// shapes, hd <= 256, H % KV == 0 and H / KV <= 256 before it calls this.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Tq, int S, int H, int KV,
                               int hd, int causal, int dtype, void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (S <= 0 || hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0 ||
      H / KV > MAX_ROWS || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, out, B, Tq, S, H, KV, hd, causal, st)
          : dispatch<__nv_bfloat16>(q, k, v, out, B, Tq, S, H, KV, hd, causal,
                                    st);
  return (int)err;
}

// The tensor-core route: bf16 q, k, v, out with hd 64, 80 or 128, every
// pointer 16-byte aligned.  The wrapper checks shapes, H % KV == 0 and
// T * G < 2^31 before it calls this.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* out, int B, int Tq,
                                     int S, int H, int KV, int hd, int causal,
                                     void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV != 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return (int)wg::dispatch<64>(q, k, v, out, B, Tq, S, H, KV, causal, st);
    case 80:
      return (int)wg::dispatch<80>(q, k, v, out, B, Tq, S, H, KV, causal, st);
    case 128:
      return (int)wg::dispatch<128>(q, k, v, out, B, Tq, S, H, KV, causal,
                                    st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
