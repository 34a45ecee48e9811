// Flash-decode for Hopper (sm_90a): one query token per batch row against
// a [B, S, KVH, hd] KV cache, masked by per-row lengths, online softmax.
//
// Replaces: src/repro/kernels/decode_attention.py, `decode_attention`
// (Pallas body `_decode_kernel`).
//
// Bound on an H100: bytes.  Each valid K and V row is read once (2 x len x
// hd x 2 B per (row, KV head)); the arithmetic is two multiply-adds per
// element read per query head, far below the card's ridge point.
//
// Design:
//   * One CTA of 128 threads per (batch row, KV head): 8 x 32 = 256 CTAs at
//     stablelm-1.6b's serve shapes.  The CTA walks [0, lengths[b]) in tiles
//     of 128 keys and never reads past the row's length (clamped to S).
//   * The G query heads of the KV head share every K/V row the CTA loads
//     (G is a template parameter, as is hd: 32, 64 or 128).
//   * Scores: hd/8 threads cover one key row with one 16-byte load each, so
//     a warp reads whole 128-byte rows; the partial dot products meet by
//     warp shuffles.  s = (q . k) * sm_scale in f32 (a multiply, as the
//     reference scales).
//   * Softmax: one warp per query head updates the running max m and sum l
//     in f32 for the tile and turns the scores into probabilities in shared
//     memory.
//   * P.V: each thread keeps an f32 accumulator for its 8 dimensions over
//     the keys of its lane, rescaled by exp(m_old - m_new) per tile; the
//     lanes' accumulators are added in lane order at the end.
//   * Rows with length 0 read nothing and return zeros (acc / l with the
//     l > 0 guard).  The output is bf16.
//   * Split-K over the sequence, TMA and wgmma are later work.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;  // keys per softmax tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float (&out)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, KVH * G, HD]
                        const __nv_bfloat16* __restrict__ k,  // [B, S, KVH, HD]
                        const __nv_bfloat16* __restrict__ v,  // [B, S, KVH, HD]
                        const int* __restrict__ lengths,      // [B]
                        __nv_bfloat16* __restrict__ out,      // [B, KVH * G, HD]
                        int S, int KVH, float sm_scale) {
  constexpr int TPK = HD / 8;           // threads per key row
  constexpr int KEYS = THREADS / TPK;   // key rows per pass
  constexpr int PASSES = TILE / KEYS;
  static_assert(TPK <= 32 && 32 % TPK == 0, "a key row lies within one warp");

  __shared__ float p_s[G][TILE];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ float red[KEYS][G][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key_lane = tid / TPK;
  const int part = tid % TPK;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  const size_t row_stride = (size_t)KVH * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * row_stride + (size_t)h * HD + part * 8;
  const __nv_bfloat16* vb = v + (size_t)b * S * row_stride + (size_t)h * HD + part * 8;
  const __nv_bfloat16* qb = q + ((size_t)b * KVH + h) * G * HD;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) load8(qb + (size_t)g * HD + part * 8, qr[g]);
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    // scores of this tile's keys
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int j = pass * KEYS + key_lane;
      const int key = t0 + j;
      float kv[8];
      if (key < len) {
        load8(kb + (size_t)key * row_stride, kv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qr[g][i], kv[i], s);
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (part == 0) p_s[g][j] = (key < len) ? s * sm_scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mt = NEG_INF;
      for (int j = lane; j < TILE; j += 32) mt = fmaxf(mt, p_s[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = (t0 + j < len) ? expf(p_s[g][j] - m_new) : 0.f;
        p_s[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V over this lane's keys of the tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= a;
    }
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int j = pass * KEYS + key_lane;
      if (t0 + j < len) {
        float vv[8];
        load8(vb + (size_t)(t0 + j) * row_stride, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = p_s[g][j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // p_s and alpha_s are rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) red[key_lane][g][part * 8 + i] = acc[g][i];
  __syncthreads();
  __nv_bfloat16* ob = out + ((size_t)b * KVH + h) * G * HD;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, dd = e % HD;
    float s = 0.f;
#pragma unroll
    for (int kl = 0; kl < KEYS; ++kl) s += red[kl][g][dd];
    const float l = l_s[g];
    ob[e] = __float2bfloat16(l > 0.f ? s / l : 0.f);
  }
}

template <int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   int B, int S, int KVH, float sm_scale, cudaStream_t s) {
  dim3 grid(KVH, B);
  decode_attention_kernel<HD, G><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), S, KVH, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v, const void* lengths,
                       void* out, int B, int S, int KVH, float sm_scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<HD, 1>(q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    case 2: return launch<HD, 2>(q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    case 4: return launch<HD, 4>(q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    case 8: return launch<HD, 8>(q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, int B, int S, int KVH, int G,
                                     int hd, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return dispatch_g<32>(G, q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    case 64: return dispatch_g<64>(G, q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    case 128: return dispatch_g<128>(G, q, k, v, lengths, out, B, S, KVH, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
