// The flash-decode walks shared by decode_attention.cu (contiguous cache
// rows) and paged_decode_attention.cu (rows reached through a block table).
//
// Where a key's K/V row lives is the only thing the two kernels do
// differently, so each walk takes it as a functor `row_of(key) -> row index`
// (units of one [KVH, HD] cache row).  Both kernels then run the same loads,
// reductions and roundings in the same order, so on the same logical cache
// they give bitwise equal outputs.
//
// G <= 8 (`attend`, CUDA cores): one CTA of THREADS threads handles one
// (batch row, KV head) and its G query heads: it walks keys [0, len) in
// tiles of TILE keys with an online softmax in f32 and writes the heads'
// outputs.
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
//
// G == 16 (`attend_g16`, tensor cores, split over the sequence; glm4-9b):
// one CTA of 4 warps per (batch row, KV head, split of SPLIT keys), where
// SPLIT is fixed by the caller (a multiple of WT), so a row's splits, and
// so its output, depend on its own length only, never on B or S.
//   * The 16 query heads of the KV head are the M = 16 rows of mma.sync
//     m16n8k16 tiles; their A fragments are loaded once into registers.
//     Each K/V row is read once, by one warp.
//   * Each warp walks every 4th tile of WT = 32 keys of the split (tile
//     w, w + 4, ...), staged by cp.async 16-byte copies, one key row at a
//     time through `row_of`, in its own ring of RING = 3 stages (rows
//     padded by 16 bytes so the fragment reads hit 32 distinct banks; keys
//     past the split's end are zero-filled and masked).  Per tile: S = Q K^T
//     (four independent 8-key fragments), the online softmax in f32 with
//     quad shuffles (exp as one ex2), P rounded to bf16 as the Pallas body
//     casts p to v's dtype, and P.V by mma.sync in two 16-key steps with V
//     read by ldmatrix.trans.
//   * The 4 warps' (m, l, acc) meet in shared memory and are combined in
//     warp order.  A row with one split writes acc / l in bf16 directly; a
//     row with more writes its splits' normalised partials o and
//     log-sum-exps (scratch allocated by the caller), and `combine_kernel`
//     adds them in split order, each weighted by exp(lse - max lse).
//
// Both walks: len == 0 reads nothing and returns zeros (acc / l with the
// l > 0 guard).  The output is bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace decode_core {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;  // keys per softmax tile (G <= 8)
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

// ---------------------------------------------------------------------------
// G == 16: tensor cores, split over the sequence
// ---------------------------------------------------------------------------

constexpr int MMA_G = 16;  // query heads of one KV head: the M of m16n8k16
constexpr int WT = 32;     // keys per warp tile: two 16-key steps of P.V
constexpr float LOG2E = 1.4426950408889634f;
constexpr int RING = 3;    // cp.async stages per warp

template <int HD>
struct G16Smem {
  static constexpr int PITCH = HD + 8;                      // bf16 per shared row
  static constexpr int TILE_ELEMS = WT * PITCH;             // one K or V tile
  static constexpr int WARP_ELEMS = RING * 2 * TILE_ELEMS;  // one warp's ring
  static constexpr int RING_BYTES = WARPS * WARP_ELEMS * 2;
  static constexpr int RED_BYTES = WARPS * MMA_G * (HD + 2) * 4;  // each warp's acc, m, l
  static constexpr int BYTES = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

// splits of `split` keys over [0, len); a row of length 0 keeps one
__host__ __device__ __forceinline__ int n_splits(int len, int split) {
  return len > split ? (len + split - 1) / split : 1;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, each transposed: lane l gives
// the address of row (l & 7) of matrix (l >> 3)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes device -> shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Split `s` of one (batch row, KV head).  q_h: the 16 query rows [16, HD];
// k_h, v_h: the K/V bases offset to this KV head (row r of the cache starts
// at k_h + r * row_stride); out_h: [16, HD]; part_o [n_split_max, 16, HD]
// and part_lse [n_split_max, 16]: this (row, KV head)'s scratch, read only
// when the row has more than one split; smem: G16Smem<HD>::BYTES.
//
// mma.m16n8k16 fragments (lane = 4 * quad + qi): A holds rows quad and
// quad + 8, columns 2 qi (+1) and 2 qi + 8 (+1); B holds columns (n) quad,
// rows (k) 2 qi (+1) and 2 qi + 8 (+1); C holds rows quad and quad + 8,
// columns 2 qi (+1).  The lower column or row sits in the low half.
template <int HD, class RowOf>
__device__ __forceinline__ void attend_g16(const __nv_bfloat16* __restrict__ q_h,
                                           const __nv_bfloat16* __restrict__ k_h,
                                           const __nv_bfloat16* __restrict__ v_h,
                                           size_t row_stride, int len, int split, int s,
                                           RowOf row_of, __nv_bfloat16* __restrict__ out_h,
                                           float* __restrict__ part_o,
                                           float* __restrict__ part_lse, float sm_scale,
                                           uint8_t* smem) {
  using L = G16Smem<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks per key row
  static_assert((WT * CH) % 32 == 0, "a tile's chunks spread evenly over a warp");
  const int n_split = n_splits(len, split);
  if (s >= n_split) return;
  const int k_begin = s * split, k_end = min(len, k_begin + split);
  const int n_tiles = (k_end - k_begin + WT - 1) / WT;  // 0 when len == 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, qi = lane & 3;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + warp * L::WARP_ELEMS;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  // this warp's i-th tile (keys from k_begin + (warp + 4 i) * WT) into stage i % RING
  auto load = [&](int i) {
    const int key0 = k_begin + (warp + i * WARPS) * WT;
    __nv_bfloat16* ks = ring + (i % RING) * 2 * L::TILE_ELEMS;
    __nv_bfloat16* vs = ks + L::TILE_ELEMS;
#pragma unroll
    for (int e = lane; e < WT * CH; e += 32) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = key0 + r < k_end;
      const size_t row = ok ? row_of(key0 + r) : 0;
      cp_async16(ks + r * L::PITCH + c, k_h + row * row_stride + c, ok);
      cp_async16(vs + r * L::PITCH + c, v_h + row * row_stride + c, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }

  // Q's A fragments, once, straight from device memory
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + qi * 2;
    qf[kk][0] = ld32(q_h + quad * HD + c);
    qf[kk][1] = ld32(q_h + (quad + 8) * HD + c);
    qf[kk][2] = ld32(q_h + quad * HD + c + 8);
    qf[kk][3] = ld32(q_h + (quad + 8) * HD + c + 8);
  }
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < mine; ++i) {
    if (i + RING - 1 < mine) load(i + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();  // tile i has landed (this lane's copies)
    __syncwarp();               // ... and every lane's
    const __nv_bfloat16* ks = ring + (i % RING) * 2 * L::TILE_ELEMS;
    const __nv_bfloat16* vs = ks + L::TILE_ELEMS;
    const int key0 = k_begin + (warp + i * WARPS) * WT;

    // S = Q K^T: 16 heads x WT keys, NJ independent 8-key fragments
    constexpr int NJ = WT / 8;
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + quad) * L::PITCH + kk * 16 + qi * 2;
        mma_bf16(sc[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale and mask; the heads' maxima over the quad's 4 lanes
    float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + qi * 2 + (e & 1) < k_end;
        sc[j][e] = ok ? sc[j][e] * sm_scale : NEG_INF;
        if (e < 2) mt_lo = fmaxf(mt_lo, sc[j][e]);
        else mt_hi = fmaxf(mt_hi, sc[j][e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, off));
      mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mt_lo), mn_hi = fmaxf(m_hi, mt_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + qi * 2 + (e & 1) < k_end;
        const float p = ok ? ex2((sc[j][e] - (e < 2 ? mn_lo : mn_hi)) * LOG2E) : 0.f;
        sc[j][e] = p;
        if (e < 2) sum_lo += p;
        else sum_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    const float a_lo = ex2((m_lo - mn_lo) * LOG2E), a_hi = ex2((m_hi - mn_hi) * LOG2E);
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= a_lo;
      o[j][1] *= a_lo;
      o[j][2] *= a_hi;
      o[j][3] *= a_hi;
    }

    // O += P V, 16 keys per step: P rounded to bf16 is the A fragment (16
    // heads x 16 keys); V's B fragments by ldmatrix.trans, two 8-dim column
    // blocks per call
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        // lanes 0-15: keys 16 kk + (lane & 15) at dims 8 j; lanes 16-31: dims 8 (j + 1)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 15)) * L::PITCH + (j + (lane >> 4)) * 8);
        mma_bf16(o[j], a, bv[0], bv[1]);
        mma_bf16(o[j + 1], a, bv[2], bv[3]);
      }
    }
    __syncwarp();  // every lane is done with stage i % RING before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the buffer becomes the reduction area

  // the warps' (m, l, acc) meet in shared memory, combined in warp order
  float* red_o = reinterpret_cast<float*>(smem);  // [WARPS][16][HD]
  float* red_m = red_o + WARPS * MMA_G * HD;  // [WARPS][16]: m, then each warp's weight
  float* red_l = red_m + WARPS * MMA_G;       // [WARPS][16]: l, then the sum in [0][g]
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + qi * 2;
    *reinterpret_cast<float2*>(red_o + (warp * MMA_G + quad) * HD + c) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(red_o + (warp * MMA_G + quad + 8) * HD + c) =
        make_float2(o[j][2], o[j][3]);
  }
  if (qi == 0) {
    red_m[warp * MMA_G + quad] = m_lo;
    red_m[warp * MMA_G + quad + 8] = m_hi;
    red_l[warp * MMA_G + quad] = l_lo;
    red_l[warp * MMA_G + quad + 8] = l_hi;
  }
  __syncthreads();
  float m = NEG_INF;  // head tid's max over the warps, and its weights exp(m_w - m)
  if (tid < MMA_G) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red_m[w * MMA_G + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(red_m[w * MMA_G + tid] - m);
      l += red_l[w * MMA_G + tid] * c;
      red_m[w * MMA_G + tid] = c;
    }
    red_l[tid] = l;
  }
  __syncthreads();
  if (n_split > 1 && tid < MMA_G) part_lse[s * MMA_G + tid] = m + logf(red_l[tid]);
  for (int e = tid; e < MMA_G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red_o[(w * MMA_G + g) * HD + d] * red_m[w * MMA_G + g];
    const float l = red_l[g];
    if (n_split == 1) out_h[e] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
    else part_o[(size_t)s * MMA_G * HD + e] = acc / l;  // a split holds a key, so l > 0
  }
}

// The splits of each row with more than one, added in split order, each
// weighted by exp(lse - max lse): one CTA of HD threads per (KV head, batch
// row, query head), thread d adding dimension d.  part_o [B, KVH,
// n_split_max, 16, HD], part_lse [B, KVH, n_split_max, 16], lengths clamped
// to [0, S] as the walk clamps them.
template <int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_lse,
               const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int S, int KVH,
               int split, int n_split_max) {
  const int h = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n = n_splits(len, split);
  if (n == 1) return;  // written by the walk itself
  const size_t bh = (size_t)b * KVH + h;
  const float* pl = part_lse + bh * n_split_max * MMA_G + g;                     // split stride 16
  const float* po = part_o + (bh * n_split_max * MMA_G + g) * HD + threadIdx.x;  // 16 HD
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, pl[s * MMA_G]);
  float wsum = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float w = expf(pl[s * MMA_G] - mx);
    wsum += w;
    acc += po[(size_t)s * MMA_G * HD] * w;
  }
  out[(bh * MMA_G + g) * HD + threadIdx.x] = __float2bfloat16(acc / wsum);
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
