// The flash-decode walk shared by decode_attention.cu (contiguous cache rows)
// and paged_decode_attention.cu (rows reached through a block table).
//
// One CTA of THREADS threads handles one (batch row, KV head) and up to
// MAX_G of its query heads: it walks keys [0, len) in tiles of TILE keys with
// an online softmax in f32 and writes those heads' outputs.  A KV head with
// G > MAX_G query heads (glm4-9b: G = 16) is split over G / MAX_G CTAs,
// each with its own MAX_G heads (`Split`), so the shared reduction buffers
// and the per-thread accumulators keep their G <= 8 sizes (`red` is
// KEYS x G x HD floats: 64 KB at G 16, hd 128, over the 48 KB of static
// shared memory).  For G <= 8 the split is 1 and the walk is unchanged.
// Where a key's K/V row lives is the only thing the two kernels do
// differently, so the walk takes it as a functor `row_of(key) -> row index`
// (units of one [KVH, HD] cache row).  Both kernels then run the same loads,
// reductions and roundings in the same order, so on the same logical cache
// they give bitwise equal outputs.
//
//   * Scores: HD/8 threads cover one key row with one 16-byte load each, so a
//     warp reads whole 128-byte rows; the partial dot products meet by warp
//     shuffles.  s = (q . k) * sm_scale in f32 (a multiply, as the reference
//     scales).
//   * Softmax: one warp per query head updates the running max m and sum l in
//     f32 for the tile and turns the scores into probabilities in shared
//     memory.
//   * P.V: each thread keeps an f32 accumulator for its 8 dimensions over the
//     keys of its lane, rescaled by exp(m_old - m_new) per tile; the lanes'
//     accumulators are added in lane order at the end.
//   * len == 0 reads nothing and returns zeros (acc / l with the l > 0
//     guard).  The output is bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace decode_core {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;  // keys per softmax tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 8;  // query heads per CTA

// G query heads per KV head -> GC heads per CTA over NS CTAs
template <int G>
struct Split {
  static constexpr int GC = G < MAX_G ? G : MAX_G;
  static constexpr int NS = G / GC;
  static_assert(G % GC == 0, "G is a multiple of MAX_G when it exceeds it");
};

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

// q_h: the G query rows of this KV head [G, HD]; k_h, v_h: the K/V bases
// offset to this KV head (row r of the cache starts at k_h + r * row_stride);
// out_h: [G, HD].
template <int HD, int G, class RowOf>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q_h,
                                       const __nv_bfloat16* __restrict__ k_h,
                                       const __nv_bfloat16* __restrict__ v_h,
                                       size_t row_stride, int len, RowOf row_of,
                                       __nv_bfloat16* __restrict__ out_h, float sm_scale) {
  constexpr int TPK = HD / 8;           // threads per key row
  constexpr int KEYS = THREADS / TPK;   // key rows per pass
  constexpr int PASSES = TILE / KEYS;
  static_assert(TPK <= 32 && 32 % TPK == 0, "a key row lies within one warp");

  __shared__ float p_s[G][TILE];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ float red[KEYS][G][HD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key_lane = tid / TPK;
  const int part = tid % TPK;
  const __nv_bfloat16* kb = k_h + part * 8;
  const __nv_bfloat16* vb = v_h + part * 8;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) load8(q_h + (size_t)g * HD + part * 8, qr[g]);
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
        load8(kb + row_of(key) * row_stride, kv);
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
        load8(vb + row_of(t0 + j) * row_stride, vv);
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
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, dd = e % HD;
    float s = 0.f;
#pragma unroll
    for (int kl = 0; kl < KEYS; ++kl) s += red[kl][g][dd];
    const float l = l_s[g];
    out_h[e] = __float2bfloat16(l > 0.f ? s / l : 0.f);
  }
}

// Host side: instantiate `Launch<HD, G>::run(args...)` for the compiled
// (hd, G) pairs; anything else is cudaErrorInvalidValue.
template <template <int, int> class Launch, int HD, class... Args>
cudaError_t dispatch_g(int G, Args... args) {
  switch (G) {
    case 1: return Launch<HD, 1>::run(args...);
    case 2: return Launch<HD, 2>::run(args...);
    case 4: return Launch<HD, 4>::run(args...);
    case 8: return Launch<HD, 8>::run(args...);
    case 16: return Launch<HD, 16>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int> class Launch, class... Args>
cudaError_t dispatch(int hd, int G, Args... args) {
  switch (hd) {
    case 32: return dispatch_g<Launch, 32>(G, args...);
    case 64: return dispatch_g<Launch, 64>(G, args...);
    case 128: return dispatch_g<Launch, 128>(G, args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_core
