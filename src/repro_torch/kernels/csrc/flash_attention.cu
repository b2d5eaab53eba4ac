// flash_attention: forward online-softmax attention over (B, T, H, hd) queries
// and (B, S, KV, hd) keys and values, optional causal masking, grouped-query
// heads (G = H / KV query heads share one kv head).
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (called through
// `flash_attention_pallas`): the encoder prefill runs it in every layer when
// the config sets `pallas_flash`.  It computes what that kernel computes, not
// what `models/layers.flash_attention` does: q is cast to f32 and scaled by
// 1/sqrt(hd) rounded to f32, masked scores are the finite -1e30, the
// probabilities stay f32 in the P.V product, and the output is
// acc / max(l, 1e-20) cast to q's type.  Query and key positions both count
// from 0; a causal row sees the keys at or before its own position.
//
// What bounds it on an H100: operations.  The work is 4 B H T S hd flops
// (q.k and p.v); at the encoder's shape (B = 2, T = S = 8192, H = 16,
// hd = 80) that is 6.9e11 flops, 10.3 ms at the 67 TFLOP/s of FP32 FMA,
// against 168 MB of Q, K, V and O, 0.05 ms of memory traffic.
//
// What the design does about it: it keeps every product in FP32 FMA (no
// tensor cores, so the f32 tolerance holds) and feeds the FMA units from
// registers and shared-memory broadcasts.  One block owns one (batch, kv
// head, tile of BQ query positions) and all G query heads of that kv head,
// one thread per (position, head) row: the thread holds its scaled q row
// and its f32 accumulator in registers.  The block stages BK keys and values
// at a time in shared memory, converted to f32; every thread reads the same
// key, so each shared load is a broadcast feeding four FMAs.  The online
// softmax advances SUB keys at a time with expf (no fast-math), in a fixed
// order, so a run repeats bit for bit.  A causal block stops at the last key
// its last row can see.  The head dimension is padded in shared memory to a
// compiled width HDP (32, 64, 80, 128 or 256) with zeros.  Tensor cores
// (wgmma with bf16 operands), TMA staging and a re-examined tolerance are
// the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// dtype: 0 float32, 1 bfloat16.  The wrapper checks shapes, hd <= 256,
// H % KV == 0 and H / KV <= 256 before it calls this.
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
