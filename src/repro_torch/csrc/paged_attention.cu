// GQA one-token decode attention read straight from the page pool.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py
// _decode_kernel (launched by paged_decode_attention).  Same function:
// for each (batch row b, kv head h) an online softmax (m, l, acc in f32)
// over the row's tokens, all G = H / Hkv query heads of h together; a
// position is valid when pos < length and, with a window, when
// pos > length - 1 - window; out = acc / max(l, 1e-30), zeros for an
// empty row.
//
// Layout: the pool is (P, page_elems) f32; page p holds page_tokens token
// rows of (2, Hkv, D) -- K of head h at t*token_elems + h*D, V at
// t*token_elems + Hkv*D + h*D -- then slack.  page_table (B, pps) holds
// physical pool rows, so the kernel reads the pool in place (the TPU path
// compacted pages into separate K and V arrays first).
//
// What bounds it on an H100: bytes.  Decode reads every valid K and V row
// once (2 x Hkv x D x 4 bytes per token per batch row) and does 4 x G x D
// flops per token and kv head, about G/2 flop per byte: far below the
// card's ~20 flop/byte f32 balance point, so the floor is the KV bytes
// over 3.35 TB/s.  At decode batch sizes the loop is latency-bound, so the
// design keeps many row loads in flight: one CTA of NWARPS warps per
// (b, h); each warp takes TOKENS consecutive tokens per trip and issues
// all their K and V row loads before it uses any (NWARPS x TOKENS x 2
// loads of D floats in flight per CTA); a lane holds D/32 contiguous dims
// (one float4 at D=128) of each row, so a K row is one coalesced warp
// load and a dot product is one butterfly reduction.  Each warp keeps its
// own (m, l, acc) in registers; the warps' partial softmaxes are merged
// once, through shared memory, by the logsumexp rule.  Tokens before the
// window and pages past length are never read.  With B x Hkv CTAs this
// fills few SMs at small batch: splitting the tokens of a row across CTAs
// is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 8;
constexpr int TOKENS = 4;        // tokens whose loads a warp keeps in flight
constexpr int GMAX = 8;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ void load_row(const float* p, float (&r)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load_row(const float* p, float (&r)[2]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  r[0] = v.x; r[1] = v.y;
}

template <int D, typename QT>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const QT* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int H, int Hkv, int pps, long long page_elems,
                    int page_tokens, int window, float scale) {
  constexpr int VEC = D / 32;
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long token_elems = 2LL * Hkv * D;

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qr[g][i] = g < G
          ? to_float(q[((long long)b * H + h * G + g) * D + lane * VEC + i]) * scale
          : 0.f;

  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const int len = lengths[b];
  const int end = min(len, pps * page_tokens);
  const int start = window > 0 ? max(0, len - window) : 0;
  const int* table = page_table + (long long)b * pps;
  // a warp takes TOKENS consecutive tokens per trip and issues all their
  // K/V loads before using any, so TOKENS row pairs are in flight at once
  for (int t0 = start + warp * TOKENS; t0 < end; t0 += NWARPS * TOKENS) {
    float kr[TOKENS][VEC], vr[TOKENS][VEC];
#pragma unroll
    for (int u = 0; u < TOKENS; ++u) {
      const int t = t0 + u;
      if (t < end) {
        const int pg = t / page_tokens;
        const float* kp = pool + (long long)table[pg] * page_elems
                          + (long long)(t - pg * page_tokens) * token_elems
                          + (long long)h * D + lane * VEC;
        load_row(kp, kr[u]);
        load_row(kp + (long long)Hkv * D, vr[u]);
      }
    }
    // guards, not breaks: fully unrolled loops keep kr/vr/acc in registers
#pragma unroll
    for (int u = 0; u < TOKENS; ++u) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (t0 + u < end && g < G) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) s = fmaf(qr[g][i], kr[u][i], s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i] * corr);
          m[g] = m_new;
        }
      }
    }
  }

  __shared__ float sm_m[NWARPS][GMAX];
  __shared__ float sm_l[NWARPS][GMAX];
  __shared__ float sm_acc[NWARPS][GMAX][D];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][g][lane * VEC + i] = acc[g][i];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += NWARPS * 32) {
    const int g = e / D, d = e % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], c, lsum);
      a = fmaf(sm_acc[w][g][d], c, a);
    }
    from_float(a / fmaxf(lsum, 1e-30f), out + ((long long)b * H + h * G + g) * D + d);
  }
}

template <int D, typename QT>
void launch(const void* q, const void* pool, const void* table, const void* lengths,
            void* out, int B, int H, int Hkv, int pps, long long page_elems,
            int page_tokens, int window, float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_decode_kernel<D, QT><<<grid, NWARPS * 32, 0, stream>>>(
      (const QT*)q, (const float*)pool, (const int*)table, (const int*)lengths,
      (QT*)out, H, Hkv, pps, page_elems, page_tokens, window, scale);
}

}  // namespace

extern "C" int paged_attention_decode(const void* q, const void* pool,
                                      const void* page_table, const void* lengths,
                                      void* out, int B, int H, int Hkv, int D,
                                      int pps, long long page_elems, int page_tokens,
                                      int window, float scale, int q_bf16,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > GMAX || Hkv > 65535 ||
      page_tokens <= 0 || pps <= 0 || page_elems % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128 && q_bf16)
    launch<128, __nv_bfloat16>(q, pool, page_table, lengths, out, B, H, Hkv, pps,
                               page_elems, page_tokens, window, scale, s);
  else if (D == 128)
    launch<128, float>(q, pool, page_table, lengths, out, B, H, Hkv, pps,
                       page_elems, page_tokens, window, scale, s);
  else if (D == 64 && q_bf16)
    launch<64, __nv_bfloat16>(q, pool, page_table, lengths, out, B, H, Hkv, pps,
                              page_elems, page_tokens, window, scale, s);
  else if (D == 64)
    launch<64, float>(q, pool, page_table, lengths, out, B, H, Hkv, pps,
                      page_elems, page_tokens, window, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
