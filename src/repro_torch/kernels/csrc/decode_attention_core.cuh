// The flash-decode walk shared by decode_attention.cu (contiguous cache
// rows) and paged_decode_attention.cu (rows reached through a block table).
//
// Where a key's K/V row lives is the only thing the two kernels do
// differently, so the walk takes it as a functor `row_of` (rows in units of
// one [KVH, HD] cache row): `row_of.tile(key0, n_keys, lane)` once per warp
// tile, then `row_of(tile, key0, r)` for its row r.  Both kernels then run
// the same loads, reductions and roundings in the same order, so on the
// same logical cache they give bitwise equal outputs.
//
// One walk for every G (query heads per KV head, 1 to 16), on the tensor
// cores, split over the sequence: one CTA of 4 warps per (batch row, KV
// head, split of `split` keys).  The split is fixed by the caller (a
// multiple of WT), so a row's splits, and so its output, depend on its own
// length only, never on B or S.
//   * The G query heads of the KV head are the first G of the M = 16 rows of
//     mma.sync m16n8k16 tiles; their A fragments are loaded once into
//     registers, rows >= G as zeros.  Decode is bound by bytes, so the
//     padded rows cost tensor-core issue slots the walk has to spare.  Each
//     K/V row is read once, by one warp.
//   * Each warp walks every 4th tile of WT = 32 keys of the split (tile w,
//     w + 4, ...): the tile's K and V rows are issued together by cp.async
//     16-byte copies into the warp's own ring (one DRAM trip for both), rows
//     padded by 16 bytes so the fragment reads hit 32 distinct banks, keys
//     past the split's end zero-filled and masked.  The ring has RING = 2
//     stages: a warp's next tile is in flight while it works on this one.
//     Per tile: S = Q K^T (four independent 8-key fragments), the online
//     softmax in f32 with quad shuffles (exp as one ex2), P rounded to bf16
//     as the Pallas body casts p to v's dtype, and P.V by mma.sync in two
//     16-key steps with V read by ldmatrix.trans.  No block barrier until
//     the end of the walk.
//   * The 4 warps' (m, l, acc) meet in shared memory and are combined in
//     warp order.  A row with one split writes acc / l in bf16 directly; a
//     row with more writes its splits' normalised partials o and
//     log-sum-exps (scratch allocated by the caller), and `combine_kernel`
//     adds them in split order, each weighted by exp(lse - max lse).
//
// len == 0 reads nothing and returns zeros (acc / l with the l > 0 guard).
// The output is bf16 (`out`); where the caller gives them, the walk or the
// combine also writes each row's output in f32 before that cast
// (`out_f32`) and its log-sum-exp (`lse`, natural log of the sum of
// exp(score) over the row's keys; -inf for a row of length 0): the
// partial a sequence shard of a sharded cache hands to the combine across
// shards.  A null `out` writes no bf16 output.
//
// `PROBE:` comments mark the lines where tools/probe_decode_walk.py patches
// its variants of the walk: keep each with its line.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace decode_core {  // PROBE: namespace

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MMA_G = 16;  // the M of m16n8k16: the most query heads per KV head
constexpr int WT = 32;     // keys per warp tile: two 16-key steps of P.V
constexpr int RING = 2;    // cp.async stages per warp; PROBE: ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// splits of `split` keys over [0, len); a row of length 0 keeps one
__host__ __device__ __forceinline__ int n_splits(int len, int split) {
  return len > split ? (len + split - 1) / split : 1;
}

template <int HD>
struct Smem {
  // bf16 per shared row: 16 bytes of padding, so the 8 rows an ldmatrix or a
  // fragment read touches start in 8 distinct 16-byte bank groups (row
  // bytes 80, 144, 176 and 272 at hd 32, 64, 80 and 128), and every row
  // starts on 16 bytes, as ldmatrix and cp.async need
  static constexpr int PITCH = HD + 8;
  static constexpr int TILE_ELEMS = WT * PITCH;  // one K or V tile
  // dynamic shared memory of one CTA: the warps' rings, which then become
  // the reduction area (each warp's acc, m and l for its G heads)
  static constexpr int BYTES = WARPS * RING * 2 * TILE_ELEMS * 2;
  static_assert(BYTES >= WARPS * MMA_G * (HD + 2) * 4, "the reduction area fits in the rings");
  static_assert(HD % 16 == 0 && (PITCH * 2) % 16 == 0, "whole k-steps, 16-byte rows");
};

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

// Split `s` of one (batch row, KV head).  q_h: the G query rows [G, HD];
// k_h, v_h: the K/V bases offset to this KV head (row r of the cache starts
// at k_h + r * row_stride); out_h: [G, HD]; part_o [n_split_max, G, HD]
// and part_lse [n_split_max, G]: this (row, KV head)'s scratch, written only
// when the row has more than one split; of32_h [G, HD] and lse_h [G]: the
// f32 output and log-sum-exp, or null (written by the walk when the row
// has one split, else by the combine); smem: Smem<HD>::BYTES.
//
// mma.m16n8k16 fragments (lane = 4 * quad + qi): A holds rows quad and
// quad + 8, columns 2 qi (+1) and 2 qi + 8 (+1); B holds columns (n) quad,
// rows (k) 2 qi (+1) and 2 qi + 8 (+1); C holds rows quad and quad + 8,
// columns 2 qi (+1).  The lower column or row sits in the low half.
template <int HD, class RowOf>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q_h,
                                       const __nv_bfloat16* __restrict__ k_h,
                                       const __nv_bfloat16* __restrict__ v_h, size_t row_stride,
                                       int len, int G, int split, int s, RowOf row_of,
                                       __nv_bfloat16* __restrict__ out_h,
                                       float* __restrict__ part_o, float* __restrict__ part_lse,
                                       float* __restrict__ of32_h, float* __restrict__ lse_h,
                                       float sm_scale, uint8_t* smem) {
  using L = Smem<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks per key row
  static_assert((WT * CH) % 32 == 0, "a tile's chunks spread evenly over a warp");
  const int n_split = n_splits(len, split);
  if (s >= n_split) return;  // PROBE: entry
  const int k_begin = s * split, k_end = min(len, k_begin + split);
  const int n_tiles = (k_end - k_begin + WT - 1) / WT;  // 0 when len == 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, qi = lane & 3;
  const bool lo = quad < G, hi = quad + 8 < G;  // this lane's fragment rows are heads
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + warp * RING * 2 * L::TILE_ELEMS;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  // this warp's i-th tile (keys from k_begin + (warp + 4 i) * WT) into stage
  // i % RING: its rows' places once, then K and V of each row together
  auto load = [&](int i) {
    const int key0 = k_begin + (warp + i * WARPS) * WT;
    __nv_bfloat16* ks = ring + (i % RING) * 2 * L::TILE_ELEMS;
    __nv_bfloat16* vs = ks + L::TILE_ELEMS;
    const auto tile = row_of.tile(key0, min(WT, k_end - key0), lane);
#pragma unroll
    for (int e = lane; e < WT * CH; e += 32) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = key0 + r < k_end;
      const size_t row = row_of(tile, key0, r);  // every lane: it may shuffle
      const size_t at = (ok ? row : 0) * row_stride + c;
      cp_async16(ks + r * L::PITCH + c, k_h + at, ok);
      cp_async16(vs + r * L::PITCH + c, v_h + at, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }

  // Q's A fragments, once, straight from device memory; rows >= G are zeros
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + qi * 2;
    qf[kk][0] = lo ? ld32(q_h + quad * HD + c) : 0u;
    qf[kk][1] = hi ? ld32(q_h + (quad + 8) * HD + c) : 0u;
    qf[kk][2] = lo ? ld32(q_h + quad * HD + c + 8) : 0u;
    qf[kk][3] = hi ? ld32(q_h + (quad + 8) * HD + c + 8) : 0u;
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

    // PROBE: compute begins
    // S = Q K^T: 16 rows x WT keys, NJ independent 8-key fragments
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

    // scale and mask; the rows' maxima over the quad's 4 lanes
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
    // rows x 16 keys); V's B fragments by ldmatrix.trans, two 8-dim column
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
    // PROBE: compute ends
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // PROBE: walk ends
  __syncthreads();  // every ring is drained: the buffer becomes the reduction area

  // the warps' (m, l, acc) of the G heads meet in shared memory, combined in
  // warp order
  float* red_o = reinterpret_cast<float*>(smem);  // [WARPS][G][HD]
  float* red_m = red_o + WARPS * G * HD;  // [WARPS][G]: m, then each warp's weight
  float* red_l = red_m + WARPS * G;       // [WARPS][G]: l, then the sum in [0][g]
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + qi * 2;
    if (lo)
      *reinterpret_cast<float2*>(red_o + (warp * G + quad) * HD + c) = make_float2(o[j][0], o[j][1]);
    if (hi)
      *reinterpret_cast<float2*>(red_o + (warp * G + quad + 8) * HD + c) =
          make_float2(o[j][2], o[j][3]);
  }
  if (qi == 0) {
    if (lo) {
      red_m[warp * G + quad] = m_lo;
      red_l[warp * G + quad] = l_lo;
    }
    if (hi) {
      red_m[warp * G + quad + 8] = m_hi;
      red_l[warp * G + quad + 8] = l_hi;
    }
  }
  __syncthreads();
  float m = NEG_INF;  // head tid's max over the warps, and its weights exp(m_w - m)
  if (tid < G) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red_m[w * G + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(red_m[w * G + tid] - m);
      l += red_l[w * G + tid] * c;
      red_m[w * G + tid] = c;
    }
    red_l[tid] = l;
  }
  __syncthreads();
  if (n_split > 1 && tid < G) part_lse[s * G + tid] = m + logf(red_l[tid]);
  if (n_split == 1 && lse_h != nullptr && tid < G)
    lse_h[tid] = red_l[tid] > 0.f ? m + logf(red_l[tid]) : __int_as_float(0xff800000);  // -inf
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red_o[(w * G + g) * HD + d] * red_m[w * G + g];
    const float l = red_l[g];
    if (n_split == 1) {
      const float o = l > 0.f ? acc / l : 0.f;
      if (out_h != nullptr) out_h[e] = __float2bfloat16(o);
      if (of32_h != nullptr) of32_h[e] = o;
    } else {
      part_o[(size_t)s * G * HD + e] = acc / l;  // a split holds a key, so l > 0
    }
  }
}  // PROBE: exit

// The splits of each row with more than one, added in split order, each
// weighted by exp(lse - max lse): one CTA of HD threads per (KV head, batch
// row, query head of the KV head), thread d adding dimension d.  part_o [B,
// KVH, n_split_max, G, HD], part_lse [B, KVH, n_split_max, G], lengths
// clamped to [0, S] as the walk clamps them; out (or null), out_f32 (or
// null) [B, KVH * G, HD], lse (or null) [B, KVH * G].
template <int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_lse,
               const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
               float* __restrict__ out_f32, float* __restrict__ lse, int S, int KVH, int G,
               int split, int n_split_max) {
  const int h = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n = n_splits(len, split);
  if (n == 1) return;  // written by the walk itself
  const size_t bh = (size_t)b * KVH + h;
  const float* pl = part_lse + bh * n_split_max * G + g;                     // split stride G
  const float* po = part_o + (bh * n_split_max * G + g) * HD + threadIdx.x;  // split stride G HD
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, pl[s * G]);
  float wsum = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float w = expf(pl[s * G] - mx);
    wsum += w;
    acc += po[(size_t)s * G * HD] * w;
  }
  const float o = acc / wsum;
  const size_t at = (bh * G + g) * HD + threadIdx.x;
  if (out != nullptr) out[at] = __float2bfloat16(o);
  if (out_f32 != nullptr) out_f32[at] = o;
  if (lse != nullptr && threadIdx.x == 0) lse[bh * G + g] = mx + logf(wsum);
}

// Host side: launch `kernel` (a walk over (KV head, batch row, split) taking
// `args...`) on a cache of S positions, n_splits(S, split) splits per row,
// then the combine where a row can have more than one split (`combine` 0
// leaves it out: a planted fault for the tests, never the wrappers' call).
// out_f32 and lse (either may be null) reach the combine as they reach the
// walk through `args...`.
// `static`: internal linkage, so each library keeps its own `smem_set` (a
// function template's static local is otherwise one object shared by every
// library the process loads, and a second library would skip its own
// cudaFuncSetAttribute).
template <int HD, class Kernel, class... Args>
static cudaError_t launch_walk(Kernel kernel, const void* lengths, void* out, const void* part_o,
                        const void* part_lse, void* out_f32, void* lse, int B, int S, int KVH,
                        int G, int split, int combine, cudaStream_t stream, Args... args) {
  if (G < 1 || G > MMA_G || split < WT || split % WT != 0 || B > 65535)
    return cudaErrorInvalidValue;
  const int n_split_max = n_splits(S, split);
  if (n_split_max > 65535 || (n_split_max > 1 && (part_o == nullptr || part_lse == nullptr)))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // one per (HD, kernel)
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kernel<<<dim3(KVH, B, n_split_max), THREADS, Smem<HD>::BYTES, stream>>>(args...);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split_max == 1 || !combine) return err;
  combine_kernel<HD><<<dim3(KVH, B, G), HD, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(out_f32), static_cast<float*>(lse), S, KVH, G, split, n_split_max);
  return cudaGetLastError();
}

// Host side: `Launch<HD>::run(args...)` for the compiled head dims; anything
// else is cudaErrorInvalidValue.
template <template <int> class Launch, class... Args>
cudaError_t dispatch(int hd, Args... args) {
  switch (hd) {
    case 32: return Launch<32>::run(args...);
    case 64: return Launch<64>::run(args...);
    case 80: return Launch<80>::run(args...);
    case 128: return Launch<128>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_core
