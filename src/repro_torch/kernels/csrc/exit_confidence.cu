// Fused early-exit head for Hopper (sm_90a): (top-1 softmax probability,
// argmax) of h @ w without writing the [B, V] logits.
//
// Replaces: src/repro/kernels/exit_confidence.py, `exit_confidence`
// (Pallas body `_exit_kernel`).
//
// Semantics, as the Pallas body: logits in f32 from bf16 products; per row
// the max m, the first index holding it, and l = sum exp(logit - m) over the
// V columns; conf = 1 / l with the l > 0 guard.  Ties go to the first index
// within a tile, across tiles and across CTAs (a later run wins only when
// its max is strictly greater).
//
// Bound on an H100: bytes.  One pass over w [d, V] bf16 is the whole cost
// (2048 x 100352 x 2 B = 411 MB at stablelm-1.6b's head, 0.123 ms at 3.35
// TB/s; 1557 MB at qwen2.5-32b's, 0.465 ms).  Even at B 64 the products take
// under a quarter of that on the tensor cores (qwen's head: 99.6 GFLOP,
// 0.10 ms at 989 TFLOP/s).
//
// Design (`exit_tile_kernel<N>`, then `exit_combine_kernel`):
//   * Tensor cores, vocab as M.  The product is logits^T [V, N] = w^T [V, d]
//     . h^T [d, N]: wgmma m64nNk16 with A = a 64-column box of w from shared
//     memory, MN-major as w lies (the descriptor's transpose bit for 16-bit
//     A), and B = the h chunk, K-major as h [B, d] lies.  N is the pass's
//     rows rounded up to 8, 16, 32 or 64 (four instantiations; the rows past
//     B are TMA's zero fill and cost tensor-core work only).  wgmma rather
//     than mma.sync + ldmatrix.trans: TMA already lays the tiles out in the
//     128-byte swizzle wgmma reads, so the consumers issue 4 instructions per
//     box and chunk and never touch w with their own loads.
//   * One pass over w for every B <= 64; the wrapper launches one pass per
//     64 rows above that (`batch_passes`).
//   * A persistent, balanced vocab split: at most one CTA per SM (the
//     wrapper's `grid_ctas`: the fewest CTAs, down to 90% of the SMs, that
//     keep each at most ceil(U / SMs) units), CTA i owning the columns
//     [lo, hi) with lo = min(V, floor(i * U / n) * UNIT), U = ceil(V / UNIT)
//     units of UNIT = 64 columns: contiguous, ascending, widths within one
//     unit of each other, empty only when U < n.  No wave tail.  The unit
//     is a whole box row, so every TMA box starts on a 128-byte boundary of
//     w: on an H100 (700 W), boxes at 16-byte offsets (units of 8) ran at
//     55-68% of the bound and at 64-byte ones (units of 32) at 64-73%, where
//     128-byte aligned ones ran at 78-90%; and w's L2 promotion is 128
//     bytes, since 256-byte promotion over rows that start off a 256-byte
//     boundary fetched a neighbour's bytes (tools/ab_exit_head.py
//     --variants).
//   * A TMA ring fed by a producer warp.  Each stage holds one 64-row
//     k-chunk of a 256-column tile (four 64 x 64 boxes of w, 32 KiB) and the
//     same k-chunk of h (N x 64, at most 8 KiB, streamed from L2 beside w and
//     never staged whole, so d is not capped).  5 or 6 stages (160-192 KiB of
//     w in flight per SM, against the ~25 KiB Little's law asks at 3.35
//     TB/s).  Boxes past the CTA's range are not loaded; TMA's out-of-range
//     fill gives zeros past V, past d and past B.
//   * Each k-chunk's wgmma chain starts afresh (4 k16 steps, 64 products)
//     and the chunk sums are added in f32 on the CUDA cores: one chain over
//     all of d left the tensor cores' accumulation error growing with d
//     (conf rel err up to 6.5e-5 at d 6144 against the gate's 1e-4, on an
//     H100, 700 W, where the earlier CUDA-core kernel read 4.7e-6).
//   * Two consumer warpgroups, two boxes (128 columns) each.  After each
//     tile, a thread reduces its four vocab columns of each of its N / 4
//     batch columns to a (max, sum-exp, first argmax); the 8 lanes holding a
//     batch column merge theirs by shuffles, and one of them folds the
//     tile's result into a running state in registers (at most 2 per
//     thread: at N 64 a state per column and thread did not fit beside the
//     accumulators).  The producer runs up to a ring ahead, so a tile's
//     epilogue overlaps the next tile's loads.  After the range, the 8
//     warps' states are combined in shared memory (one named barrier), ties
//     by index, into one partial per (row, CTA): ~132 per row.
//   * `exit_combine_kernel` combines a row's partials in CTA order, one warp
//     per row (a contiguous run per lane, then a butterfly in which the
//     lower lane is always the left operand).  An empty range's partial is
//     (m = -1e30, l = 0, idx 0), which changes nothing.
//
// Host side: the map of w is encoded once per (pointer, d, V) and kept (the
// LM head is one fixed allocation); the map of h per call; the
// shared-memory attribute is set once per instantiation.  Each exported
// function returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

constexpr int BOX = 64;               // columns of a w box, and k rows of a chunk: 128 bytes
constexpr int TILE_BOXES = 4;         // boxes per vocab tile
constexpr int TILE_V = TILE_BOXES * BOX;
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int W_BYTES = TILE_BOXES * BOX_BYTES;  // one k-chunk of a tile
constexpr int CONSUMERS = 2;                     // warpgroups, two boxes each
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int THREADS = CONSUMER_THREADS + 32;  // + the producer warp
constexpr int UNIT = 64;  // columns per unit of the vocab split: one box row (exit_confidence.UNIT)
constexpr int RING_BUDGET = 200 * 1024;         // shared memory for the ring
constexpr float NEG_INF = -1e30f;

template <int N>
struct Ring {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma N of a pass");
  static constexpr int H_BYTES = N * BOX * 2;  // N rows of one k-chunk of h
  static constexpr int STAGE = W_BYTES + (H_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGES = RING_BUDGET / STAGE < 8 ? RING_BUDGET / STAGE : 8;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "stages on swizzle-atom bounds");
  static_assert(BYTES + 3 * CONSUMER_WARPS * N * 4 <= 232448, "fits an SM's shared memory");
};

// one box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N]; A from shared memory MN-major (the
// transpose bit), B from shared memory K-major
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : WG_F8(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// (m, l, idx) of one run combined with another whose indices may lie on
// either side: the larger max wins, and on equal maxima the smaller index
__device__ __forceinline__ void merge(float& m, float& l, int& ix, float om, float ol, int oi) {
  const float mn = fmaxf(m, om);
  l = l * expf(m - mn) + ol * expf(om - mn);
  if (om > m || (om == m && oi < ix)) ix = oi;
  m = mn;
}

// (m, l, idx) of a run combined with the run to its right (later tiles,
// later CTAs)
__device__ __forceinline__ void combine(float& m, float& l, int& ix, float om, float ol, int oi) {
  const float mn = fmaxf(m, om);
  l = l * expf(m - mn) + ol * expf(om - mn);
  if (om > m) ix = oi;  // the right run wins only if strictly greater
  m = mn;
}

// Fragment layout of a warp's 16 rows of a wgmma f32 accumulator (lane =
// 4 * quad + qi): d[4 j + e] is row quad (e < 2) or quad + 8 (e >= 2) of the
// warp's rows, column 8 j + 2 qi + (e & 1).  Here a row is a vocab column
// and a column a batch row.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
exit_tile_kernel(const __grid_constant__ CUtensorMap w_map,  // w [d, V] as {V, d}
                 const __grid_constant__ CUtensorMap h_map,  // h [B, ldh] as {ldh, B}
                 float* __restrict__ part_m,                 // [B, gridDim.x]
                 float* __restrict__ part_l,                 // [B, gridDim.x]
                 int* __restrict__ part_i,                   // [B, gridDim.x]
                 int B, int d, int V, int row0) {
  using R = Ring<N>;
  constexpr int STAGES = R::STAGES;
  constexpr int NC = N / 4;  // batch columns per thread: 8 j + 2 qi + p at index 2 j + p
  constexpr int SLOTS = (NC + 7) / 8;  // running states per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red_m[CONSUMER_WARPS][N];
  __shared__ float red_l[CONSUMER_WARPS][N];
  __shared__ int red_i[CONSUMER_WARPS][N];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms on 1 KB
  auto w_s = [&](int s) { return base + (uint32_t)(s * R::STAGE); };
  auto h_s = [&](int s) { return base + (uint32_t)(s * R::STAGE + W_BYTES); };
  auto full = [&](int s) { return base + R::BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return base + R::BAR_OFF + 8u * (STAGES + s); };

  const int n = gridDim.x, cta = blockIdx.x;
  const int units = (V + UNIT - 1) / UNIT;
  const int lo = min(V, (int)((long long)cta * units / n) * UNIT);
  const int hi = min(V, (int)((long long)(cta + 1) * units / n) * UNIT);
  const int n_k = (d + BOX - 1) / BOX;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // producer: one thread issues every load, the ring running on across
    // tiles, so the next tile's chunks arrive during a tile's epilogue
    if (threadIdx.x == CONSUMER_THREADS) {
      prefetch_map(&w_map);
      prefetch_map(&h_map);
      int it = 0;
      for (int t0 = lo; t0 < hi; t0 += TILE_V) {
        const int nbox = min(TILE_BOXES, (hi - t0 + BOX - 1) / BOX);
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // the first use of a stage passes
          mbar_expect_tx(full(s), nbox * BOX_BYTES + R::H_BYTES);
          for (int b = 0; b < nbox; ++b)
            tma_load_2d(w_s(s) + b * BOX_BYTES, &w_map, full(s), t0 + b * BOX, kc * BOX);
          tma_load_2d(h_s(s), &h_map, full(s), kc * BOX, row0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes boxes 2 wg and 2 wg + 1 of every tile
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, quad = lane / 4, qi = lane % 4;
  // acc: one k-chunk's products from the tensor cores; tot: the chunks
  // added in f32 on the CUDA cores
  float acc[2][N / 2], tot[2][N / 2];
#pragma unroll
  for (int bx = 0; bx < 2; ++bx)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[bx][e] = tot[bx][e] = 0.f;
  // the running (max, sum-exp, first argmax) of column q (0 <= q < NC)
  // lives on the quad lane q % 8, in slot q / 8
  float m[SLOTS], l[SLOTS];
  int ix[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    m[q] = NEG_INF;
    l[q] = 0.f;
    ix[q] = 0;
  }

  int it = 0;
  for (int t0 = lo; t0 < hi; t0 += TILE_V) {
    const int nbox = min(TILE_BOXES, (hi - t0 + BOX - 1) / BOX);
    const int mine = min(2, max(0, nbox - 2 * wg));  // boxes of this warpgroup in the tile
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      if (mine > 0) {
        pin(acc[0]);
        pin(acc[1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk) {
          // B: h rows of 128 bytes, the k16 step 32 bytes along them; A: 16
          // w rows per k16 step, 8-row groups 1 KiB apart
          const uint64_t db = wg_desc(h_s(s) + kk * 32, 16, 8 * 128, 1);
          const uint32_t a0 = w_s(s) + 2 * wg * BOX_BYTES + kk * 16 * 128;
          wgmma_tn<N>(acc[0], wg_desc(a0, BOX_BYTES, 8 * 128, 1), db, kk > 0);
          if (mine > 1)
            wgmma_tn<N>(acc[1], wg_desc(a0 + BOX_BYTES, BOX_BYTES, 8 * 128, 1), db, kk > 0);
        }
        wg_commit();
        wg_wait_all();
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
#pragma unroll
          for (int e = 0; e < N / 2; ++e) tot[bx][e] = (kc > 0 ? tot[bx][e] : 0.f) + acc[bx][e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }
    if (mine == 0) continue;

    // the tile's epilogue, per batch column: this thread's four vocab
    // columns in ascending order (box 0 rows quad and quad + 8, then box
    // 1's; a strict comparison keeps the first index), then the tile's
    // partial over the column's 8 quad lanes (ties by index: their vocab
    // columns interleave), folded into the owner lane's running state
    // (tiles ascend: a later tile wins only when strictly greater)
    const int v0 = t0 + 2 * wg * BOX + 16 * warp + quad;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = 2 * j + p;
        float x[4];
        bool ok[4];
        float tm = NEG_INF, ts = 0.f;
        int ti = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int bx = r / 2, hh = r % 2;
          const int v = v0 + bx * BOX + 8 * hh;
          x[r] = tot[bx][4 * j + 2 * hh + p];
          ok[r] = bx < mine && v < hi;
          if (ok[r] && x[r] > tm) {
            tm = x[r];
            ti = v;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) ts += ok[r] ? expf(x[r] - tm) : 0.f;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float om = __shfl_xor_sync(0xffffffffu, tm, off);
          const float os = __shfl_xor_sync(0xffffffffu, ts, off);
          const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
          merge(tm, ts, ti, om, os, oi);
        }
        if (quad == q % 8) combine(m[q / 8], l[q / 8], ix[q / 8], tm, ts, ti);
      }
    }
  }

  // the CTA's partial per batch column: the 8 consumer warps' states (each
  // over other vocab columns, so ties go by index)
  const int cw = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    if (quad == q % 8) {
      const int c = 8 * (q / 2) + 2 * qi + q % 2;
      red_m[cw][c] = m[q / 8];
      red_l[cw][c] = l[q / 8];
      red_i[cw][c] = ix[q / 8];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMER_THREADS) : "memory");  // consumers only
  const int c = threadIdx.x;
  if (c < N && row0 + c < B) {
    float mm = red_m[0][c], ll = red_l[0][c];
    int ii = red_i[0][c];
    for (int cw8 = 1; cw8 < CONSUMER_WARPS; ++cw8)
      merge(mm, ll, ii, red_m[cw8][c], red_l[cw8][c], red_i[cw8][c]);
    const size_t o = (size_t)(row0 + c) * n + cta;
    part_m[o] = mm;
    part_l[o] = ll;
    part_i[o] = ii;
  }
}

__global__ void exit_combine_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ conf, int* __restrict__ idx,
                                    float* __restrict__ mx, int nt) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int per = (nt + 31) / 32;
  const int lo = min(nt, lane * per);
  const int hi = min(nt, lo + per);
  float m = NEG_INF, l = 0.f;  // the empty run: combining with it changes nothing
  int ix = 0;
  for (int t = lo; t < hi; ++t) {
    const size_t o = (size_t)b * nt + t;
    combine(m, l, ix, part_m[o], part_l[o], part_i[o]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
    if (lane & off) {  // this lane holds the right run: the partner is the left
      float lm = om, ll = ol;
      int li = oi;
      combine(lm, ll, li, m, l, ix);
      m = lm;
      l = ll;
      ix = li;
    } else {
      combine(m, l, ix, om, ol, oi);
    }
  }
  if (lane == 0) {
    conf[b] = 1.f / (l > 0.f ? l : 1.f);
    idx[b] = ix;
    if (mx != nullptr) mx[b] = m;
  }
}

// a 2-D map over bf16 [rows, cols] (cols contiguous, `ld` elements apart),
// boxes of `box_rows` x 64 columns in the 128-byte swizzle, zeros outside
bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int ld, int box_rows,
               CUtensorMapL2promotion promo) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t boxes[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promo,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of w, encoded once per (pointer, d, V): the LM heads are fixed
// allocations, called thousands of times a serve
const CUtensorMap* w_map_for(const void* w, int d, int V) {
  struct Entry {
    const void* ptr;
    int d, V;
    CUtensorMap map;
  };
  constexpr int SLOTS = 16;
  static Entry cache[SLOTS];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].ptr == w && cache[i].d == d && cache[i].V == V) return &cache[i].map;
  Entry& e = cache[next];
  if (!encode_2d(&e.map, w, d, V, V, BOX, CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) return nullptr;
  e.ptr = w;
  e.d = d;
  e.V = V;
  next = (next + 1) % SLOTS;
  if (used < SLOTS) ++used;
  return &e.map;
}

template <int N>
cudaError_t launch_pass(const CUtensorMap& w_map, const void* h, int ldh, float* part_m,
                        float* part_l, int* part_i, int B, int d, int V, int row0, int n_ctas,
                        cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        exit_tile_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<N>::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap h_map;
  if (!encode_2d(&h_map, h, B, ldh, ldh, N, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return cudaErrorInvalidValue;
  exit_tile_kernel<N><<<n_ctas, THREADS, Ring<N>::BYTES, s>>>(w_map, h_map, part_m, part_l,
                                                              part_i, B, d, V, row0);
  return cudaGetLastError();
}

}  // namespace

// One pass: batch rows [row0, row0 + rows) of h [B, ldh] (the first d of
// each row used) against w [d, V], over `n_ctas` CTAs.  part_* are [B,
// n_ctas]; conf and idx [B]; mx [B] (or null: not written) each row's max
// logit, with which the row's log-sum-exp is mx - log(conf): what a vocab
// shard of a split head hands to the combine across shards.
extern "C" int exit_confidence_bf16(const void* h, const void* w, void* part_m, void* part_l,
                                    void* part_i, void* conf, void* idx, void* mx, int B, int d,
                                    int ldh,
                                    int V, int row0, int rows, int n_ctas, void* stream) {
  if (V % 8 != 0 || d < 1 || ldh < d || ldh % 8 != 0 || rows < 1 || rows > 64 || row0 < 0 ||
      row0 + rows > B || n_ctas < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return cudaErrorInvalidValue;
  const CUtensorMap* w_map = w_map_for(w, d, V);
  if (w_map == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (rows <= 8) err = launch_pass<8>(*w_map, h, ldh, pm, pl, pi, B, d, V, row0, n_ctas, s);
  else if (rows <= 16) err = launch_pass<16>(*w_map, h, ldh, pm, pl, pi, B, d, V, row0, n_ctas, s);
  else if (rows <= 32) err = launch_pass<32>(*w_map, h, ldh, pm, pl, pi, B, d, V, row0, n_ctas, s);
  else err = launch_pass<64>(*w_map, h, ldh, pm, pl, pi, B, d, V, row0, n_ctas, s);
  if (err != cudaSuccess) return err;
  const size_t off = (size_t)row0 * n_ctas;
  exit_combine_kernel<<<rows, 32, 0, s>>>(pm + off, pl + off, pi + off,
                                          static_cast<float*>(conf) + row0,
                                          static_cast<int*>(idx) + row0,
                                          mx != nullptr ? static_cast<float*>(mx) + row0 : nullptr,
                                          n_ctas);
  return cudaGetLastError();
}
