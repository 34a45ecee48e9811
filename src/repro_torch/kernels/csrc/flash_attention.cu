// Prefill flash attention for Hopper (sm_90a): q [B, Sq, Hq, hd] against
// k, v [B, Sk, KVH, hd], causal with an optional sliding window (or not
// causal), GQA (query head h reads KV head h / G), online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention`
// (Pallas body `_flash_kernel`).
//
// Semantics, as the Pallas body: s = (q . k) * sm_scale in f32; a key is
// visible when k_pos < Sk, and (causal) q_pos >= k_pos, and (window)
// k_pos > q_pos - window, with TOP-LEFT positions (q_pos and k_pos both
// start at 0, also when Sk > Sq); masked scores are -1e30.  Per key tile:
// m_new = max(m, tile max), p = exp(s - m_new) zeroed where masked,
// alpha = exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha +
// (p cast to v's dtype) . v in f32.  Output acc / (l > 0 ? l : 1) in q's
// dtype, so a fully masked row gives zeros.
//
// Bound on an H100, at the port's shapes (bf16):
//   * stablelm-1.6b's first prefill batch, B 8, S 104, 32 heads of 64:
//     13.6 MB of q, k, v and out against 0.36 GFLOP of causal products, so
//     BYTES: 0.0041 ms at 3.35 TB/s (the FLOPs take 0.0004 ms at 989 TFLOP/s);
//   * one 2048-token prompt, 32 heads of 64: 17.2 GFLOP against 33.6 MB, so
//     OPERATIONS: 0.0174 ms (the bytes take 0.0100 ms); at glm4-9b's heads
//     (32 over 2 KV heads of 128) 34.4 GFLOP, 0.0347 ms;
//   * phi-3-vision-4.2b's heads (32 over 32 of 96), a prompt batch of B 4,
//     S 512: 50.3 MB against 6.5 GFLOP, so BYTES: 0.015 ms;
//   * mixtral-8x7b's heads (32 over 8 of 128) with its 4096-key window, one
//     8192-token prompt: 25.2 M (row, key) pairs in the band, 412 GFLOP
//     against 168 MB, so OPERATIONS: 0.417 ms.
//
// Design (bf16, `flash_wgmma_kernel`, the FA3 shape):
//   * Work tiles of (128 query rows, query head, batch row), the last
//     (longest) query tiles first.  A persistent grid of at most one CTA
//     per SM, each of three warpgroups, walks the work tiles in a snake
//     order (round j: tile j * gridDim + blockIdx, or gridDim - 1 -
//     blockIdx in odd rounds), which evens out the CTAs' causal work.
//     The Pallas grid's sequential KV axis, whose (m, l, acc) lives in
//     VMEM, becomes a loop inside the CTA.  Warpgroup 0 is the producer:
//     one thread issues TMA loads of each work tile's Q (into one of two
//     slots) and of its K and V tiles into a ring of STAGES stages (3 at
//     hd <= 96, 2 at hd 128) in dynamic shared memory, each completing on
//     its own mbarrier, and waits on a slot's or a stage's "empty" barrier
//     before reusing it (K and V of a stage are released apart, so K
//     reloads while the stage's P V still runs); the ring runs on across
//     work tiles, so the next tile's loads overlap this one's products.
//     Warpgroups 1 and 2 are consumers, 64 query rows each (wgmma's M):
//     they wait on the "full" barriers and release K when Q K^T is done and
//     V when P V is done.
//     `setmaxnreg` moves registers from the producer (24) to the consumers
//     (240).
//   * Tiles: 128 query rows per work tile, FA_N = 128 keys per K/V tile at every
//     hd (32, 64, 80, 96, 128): the S accumulator is 64 f32 per thread, the output
//     accumulator hd / 2.  TMA maps are 4-D over [B, S, H, hd]; a box is one
//     head's rows of at most 64 columns (128 bytes, the 128-byte swizzle's
//     span), so hd 128 loads as two 64-column boxes and the descriptors walk
//     them the same way; hd 32 rows are 64 bytes and take the 64-byte
//     swizzle.  A 160-byte row of hd 80 fits no swizzle span, so it loads
//     as five 16-column boxes of 32-byte rows under the 32-byte swizzle:
//     each k-step of Q K^T reads one box (K-major, 8-row groups 256 bytes
//     apart), and P V's B operand (MN-major) steps from box to box by the
//     descriptor's leading offset, as hd 128's two boxes do; P V is one
//     wgmma m64n80k16 per 16 keys.  hd 96's 192-byte rows load as three
//     32-column boxes of 64-byte rows under the 64-byte swizzle (hd 32's
//     box), 24 KB tiles on 1 KB bounds: a k-step of Q K^T reads half a box,
//     P V steps over the three boxes by the leading offset and is one wgmma
//     m64n96k16 per 16 keys.  The boxes' out-of-range fill gives
//     zeros past Sq and Sk, so nothing is padded.
//   * S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//     hd / 16 steps.  Softmax in registers: the scores are masked, and
//     scaled by a multiply inside the exponent (one FMA by sm_scale *
//     log2(e), then one ex2), and each
//     thread's two rows' m and l are reduced over the 4 lanes of a quad (the
//     wgmma accumulator of a warp's 16 rows is laid out as mma.sync's
//     m16n8 C fragments, one per 8 columns).  P is rounded to bf16 in
//     registers, as the Pallas body casts p to v's dtype; those registers
//     are the A fragments of O += P V (wgmma m64n{hd}k16 with A from
//     registers, no shuffle needed for 16-bit types), with V read from
//     shared memory MN-major through the descriptor's transpose bit.  The
//     accumulator is rescaled by alpha in registers before each P V.
//   * The loop runs over the key tiles of the band only: from the window
//     bound of the work tile's first row (rounded down to a tile) to the
//     causal bound of its last row, so whole tiles outside the causal or
//     window band are neither loaded nor computed.  A tile that is fully
//     inside the band for all 64 rows of a warpgroup skips the mask.
//   * A row's result does not depend on B, Sq or its place in the batch:
//     query tiles and key tiles start at absolute positions (multiples of
//     128), the tiles are reduced in a fixed order, and a tile that is fully
//     masked for a row leaves its m, l and acc bitwise unchanged (alpha is
//     exactly 1, p exactly 0).
//   * The output is written from the accumulators straight to device
//     memory (bf16 pairs).
//   * Tried on an H100 (700 W) and left out, both slower: issuing a tile's
//     Q K^T together with the previous tile's P V so that the softmax runs
//     beside it (FA3's intra-warpgroup overlap: 0.099 against 0.080 ms at
//     2048 tokens, hd 64), and ping-pong of the two consumers on named
//     barriers (no gain with or without it).
//
// f32 (`flash_simple_kernel`, the tests' sweep; not on the serve's path):
// one CTA of 256 threads per (64 query rows, head, batch row), 4 threads
// per row each owning every 4th dimension; K/V tiles of 32 keys in shared
// memory as f32; scores by FMAs and quad shuffles.  The same band, masks,
// online softmax and output rule.
//
// The host side encodes the three tensor maps per call with
// cuTensorMapEncodeTiled from libcuda, looked up through the CUDA runtime
// (the build links no -lcuda; `hopper_tma.cuh`).  Each exported function returns
// cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// key positions [begin, end) a query tile [q0, q_last] can see; begin is a
// multiple of `tile`, so tiles start at absolute positions
__device__ __forceinline__ int2 key_band(int q0, int q_last, int Sk, int causal, int window,
                                         int tile) {
  int end = Sk;
  if (causal) end = min(end, q_last + 1);
  int begin = 0;
  if (window > 0) begin = max(0, q0 - window + 1) / tile * tile;
  return make_int2(begin, end);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal, int window) {
  return kp < Sk && (!causal || qp >= kp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG = 128;             // threads per warpgroup
constexpr int FA_THREADS = 3 * WG;  // producer + two consumers
constexpr int FA_M = 128;           // query rows per work tile (64 per consumer)
constexpr int FA_N = 128;           // keys per K/V tile
constexpr int CONSUMER_WARPS = 8;

template <int HD>
struct FaSmem {
  // columns per TMA box: 64 (hd 64, 128), 32 (hd 32, 96) or 16 (hd 80)
  static constexpr int BOX = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int NBOX = HD / BOX;
  static constexpr int ROW = BOX * 2;  // bytes per shared row: the swizzle span
  // descriptor layout: the 128-, 64- or 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int STAGES = HD == 128 ? 2 : 3;        // K/V ring depth
  static constexpr int Q_BYTES = FA_M * HD * 2;
  static constexpr int KV_BYTES = FA_N * HD * 2;
  static constexpr int K_OFF = 2 * Q_BYTES;  // two Q slots
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // Q full and empty per slot; K full, V full, K empty and V empty per stage
  static constexpr int BYTES = BAR_OFF + 8 * (4 + 4 * STAGES) + 1024;  // + alignment slack
  static_assert(HD == 32 || HD == 64 || HD == 80 || HD == 96 || HD == 128,
                "hd 32, 64, 80, 96 or 128");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles on swizzle-atom bounds");
  static_assert(BYTES <= 232448, "fits an SM's shared memory");
};

// the work tile of round j for this CTA among `grid`
__device__ __forceinline__ int snake(int j, int grid) {
  return j * grid + (j % 2 ? grid - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// work tile w -> (first query row, query head, batch row): the last (longest)
// query tiles first; heads of one KV head next to each other
struct Work {
  int q0, h, b;
  __device__ __forceinline__ Work(int w, int n_m, int Hq, int B) {
    const int per_m = Hq * B;
    q0 = (n_m - 1 - w / per_m) * FA_M;
    h = w % per_m % Hq;
    b = w % per_m / Hq;
  }
};

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24),
        WG_F8(d, 32),
        WG_F8(d, 40),
        WG_F8(d, 48),
        WG_F8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32]; A from registers, B from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A from registers, B from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A from registers, B from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24),
        WG_F8(d, 32),
        WG_F8(d, 40),
        WG_F8(d, 48),
        WG_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 80] (+)= A[64 x 16] . B[16 x 80]; A from registers, B from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24),
        WG_F8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 96] (+)= A[64 x 16] . B[16 x 96]; A from registers, B from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0),
        WG_F8(d, 8),
        WG_F8(d, 16),
        WG_F8(d, 24),
        WG_F8(d, 32),
        WG_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (HD == 32) wgmma_rs_n32(o, a, desc_v, 1);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, desc_v, 1);
  else if constexpr (HD == 80) wgmma_rs_n80(o, a, desc_v, 1);
  else if constexpr (HD == 96) wgmma_rs_n96(o, a, desc_v, 1);
  else wgmma_rs_n128(o, a, desc_v, 1);
}

// Fragment layout of a warp's 16 rows of a wgmma f32 accumulator (lane =
// 4 * quad + qi): d[4 j + e] is row quad (e < 2) or quad + 8 (e >= 2) of the
// warp's rows, column 8 j + 2 qi + (e & 1).  The A fragment of m64nNk16
// from registers has the same rows and, for columns [16 kk, 16 kk + 16),
// the registers {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4],
// d[8kk+5]}, {d[8kk+6], d[8kk+7]} as bf16 pairs (lower column in the low half).
template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, Sq, Hq, HD]
                   const __grid_constant__ CUtensorMap k_map,  // [B, Sk, KVH, HD]
                   const __grid_constant__ CUtensorMap v_map,  // [B, Sk, KVH, HD]
                   __nv_bfloat16* __restrict__ out,            // [B, Sq, Hq, HD]
                   int B, int Sq, int Sk, int Hq, int KVH, int causal, int window,
                   float sm_scale) {
  using L = FaSmem<HD>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms on 1 KB
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto q_full = [&](int j) { return bars + 8u * j; };
  auto q_empty = [&](int j) { return bars + 8u * (2 + j); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (4 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (4 + 3 * STAGES + s); };

  const int n_m = (Sq + FA_M - 1) / FA_M;
  const int n_work = n_m * Hq * B;
  const int G = Hq / KVH;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full(j), 1);
      mbar_init(q_empty(j), CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMER_WARPS);
      mbar_init(v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same work tiles: round j takes tile j * gridDim.x +
  // blockIdx.x, counted backwards in odd rounds (a snake, so that each CTA's
  // share of the heaviest-first tiles evens out), in Q slot j % 2, its key
  // tiles through the ring at the running tile count `it`, so the next work
  // tile's loads overlap this one's products.
  if (threadIdx.x < WG) {
    // producer: one thread issues every load; the rest of the warpgroup
    // only gives its registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      int it = 0;
      for (int j = 0, w = blockIdx.x; w < n_work; w = snake(++j, gridDim.x)) {
        const Work t(w, n_m, Hq, B);
        const int qs = j % 2;
        mbar_wait(q_empty(qs), ((j / 2) & 1) ^ 1);  // the first use of a slot passes
        mbar_expect_tx(q_full(qs), L::Q_BYTES);
        for (int c = 0; c < L::NBOX; ++c)
          tma_load(q_s + qs * L::Q_BYTES + c * FA_M * L::ROW, &q_map, q_full(qs), c * L::BOX,
                   t.h, t.q0, t.b);
        const int2 band = key_band(t.q0, min(t.q0 + FA_M, Sq) - 1, Sk, causal, window, FA_N);
        for (int t0 = band.x; t0 < band.y; t0 += FA_N, ++it) {
          const int s = it % STAGES;
          const uint32_t ks = k_s + s * L::KV_BYTES, vs = v_s + s * L::KV_BYTES;
          mbar_wait(k_empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
          for (int c = 0; c < L::NBOX; ++c)
            tma_load(ks + c * FA_N * L::ROW, &k_map, k_full(s), c * L::BOX, t.h / G, t0, t.b);
          mbar_wait(v_empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
          for (int c = 0; c < L::NBOX; ++c)
            tma_load(vs + c * FA_N * L::ROW, &v_map, v_full(s), c * L::BOX, t.h / G, t0, t.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ct = threadIdx.x - WG;
    const int cw = ct / WG;  // consumer 0 or 1: query rows [64 cw, 64 cw + 64) of a tile
    const int warp = (ct / 32) % 4, lane = ct % 32, quad = lane / 4, qi = lane % 4;
    const float scale2 = sm_scale * LOG2E;  // exp(x sm_scale) = 2^(x scale2)
    const size_t q_row = (size_t)Hq * HD;
    int it = 0;
    for (int j = 0, w = blockIdx.x; w < n_work; w = snake(++j, gridDim.x)) {
      const Work t(w, n_m, Hq, B);
      const int qs = j % 2;
      const uint32_t qa = q_s + qs * L::Q_BYTES + cw * 64 * L::ROW;  // this consumer's 64 rows
      const int row0 = t.q0 + 64 * cw;
      const int r_lo = row0 + 16 * warp + quad, r_hi = r_lo + 8;
      const int2 band = key_band(t.q0, min(t.q0 + FA_M, Sq) - 1, Sk, causal, window, FA_N);

      float o[HD / 2];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
      float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
      mbar_wait(q_full(qs), (j / 2) & 1);

      for (int t0 = band.x; t0 < band.y; t0 += FA_N, ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const uint32_t ks = k_s + s * L::KV_BYTES, vs = v_s + s * L::KV_BYTES;

        // S = Q K^T: 64 rows x 128 keys, hd / 16 steps
        float sc[FA_N / 2];
        mbar_wait(k_full(s), ph);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t box = kk * 16 / L::BOX, col = (kk * 16 % L::BOX) * 2;
          const uint64_t da = wg_desc(qa + box * FA_M * L::ROW + col, 16, 8 * L::ROW, L::LAYOUT);
          const uint64_t db = wg_desc(ks + box * FA_N * L::ROW + col, 16, 8 * L::ROW, L::LAYOUT);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wg_commit();
        wg_wait_all();
        pin(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(s));  // this warp is done with K of stage s

        // mask; the row maxima over the quad's 4 lanes.  A tile inside the
        // band for all 64 rows skips the mask.  The maxima are taken on the
        // raw scores (the scale is positive) and the scale is applied inside
        // the exponent: p = 2^(s scale2 - m scale2).
        const bool inside = t0 + FA_N <= Sk && (!causal || t0 + FA_N - 1 <= row0) &&
                            (window <= 0 || t0 > row0 + 63 - window);
        uint64_t vis = ~0ull;
        if (!inside) {
#pragma unroll
          for (int e = 0; e < FA_N / 2; ++e) {
            const int key = t0 + (e / 4) * 8 + qi * 2 + (e & 1);
            if (!visible(e & 2 ? r_hi : r_lo, key, Sk, causal, window)) {
              vis &= ~(1ull << e);
              sc[e] = NEG_INF;
            }
          }
        }
        // maxima and sums in four interleaved chains per row (max is exact in
        // any order; the sums' order is fixed)
        float mt[2][4], sm[2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) mt[0][c] = mt[1][c] = NEG_INF;
#pragma unroll
        for (int e = 0; e < FA_N / 2; ++e) {
          float& m = mt[(e >> 1) & 1][(e >> 2) & 3];
          m = fmaxf(m, sc[e]);
        }
        float mn[2], ms[2];  // new row maxima (raw), and scaled
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = fmaxf(fmaxf(mt[r][0], mt[r][1]), fmaxf(mt[r][2], mt[r][3]));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          mn[r] = fmaxf(r ? m_hi : m_lo, v);
          ms[r] = mn[r] * scale2;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) sm[0][c] = sm[1][c] = 0.f;
        if (inside) {
#pragma unroll
          for (int e = 0; e < FA_N / 2; ++e) {
            const int r = (e >> 1) & 1;
            sc[e] = ex2(fmaf(sc[e], scale2, -ms[r]));
            sm[r][(e >> 2) & 3] += sc[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < FA_N / 2; ++e) {
            const int r = (e >> 1) & 1;
            sc[e] = (vis >> e & 1ull) ? ex2(fmaf(sc[e], scale2, -ms[r])) : 0.f;
            sm[r][(e >> 2) & 3] += sc[e];
          }
        }
        float sum[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = (sm[r][0] + sm[r][1]) + (sm[r][2] + sm[r][3]);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          sum[r] = v;
        }
        const float a_lo = ex2((m_lo - mn[0]) * scale2), a_hi = ex2((m_hi - mn[1]) * scale2);
        l_lo = l_lo * a_lo + sum[0];
        l_hi = l_hi * a_hi + sum[1];
        m_lo = mn[0];
        m_hi = mn[1];
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= (e & 2) ? a_hi : a_lo;

        // P rounded to bf16: the A fragments of O += P V
        uint32_t pa[FA_N / 16][4];
#pragma unroll
        for (int kk = 0; kk < FA_N / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
        mbar_wait(v_full(s), ph);
        pin(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FA_N / 16; ++kk) {
          // keys [16 kk, 16 kk + 16): two 8-row groups 8 rows apart (SBO); the
          // boxes of a row (hd 128's two of 64 columns, hd 96's three of 32,
          // hd 80's five of 16) lie FA_N rows apart (LBO)
          const uint64_t dv = wg_desc(vs + kk * 16 * L::ROW, FA_N * L::ROW, 8 * L::ROW, L::LAYOUT);
          wgmma_pv<HD>(o, pa[kk], dv);
        }
        wg_commit();
        wg_wait_all();
        pin(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(s));  // ... and with V of stage s
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(qs));  // ... and with Q slot qs

      const float d_lo = l_lo > 0.f ? l_lo : 1.f, d_hi = l_hi > 0.f ? l_hi : 1.f;
      __nv_bfloat16* ob = out + (size_t)t.b * Sq * q_row + (size_t)t.h * HD + qi * 2;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        if (r_lo < Sq)
          *reinterpret_cast<uint32_t*>(ob + r_lo * q_row + jd * 8) =
              pack_bf16(o[4 * jd] / d_lo, o[4 * jd + 1] / d_lo);
        if (r_hi < Sq)
          *reinterpret_cast<uint32_t*>(ob + r_hi * q_row + jd * 8) =
              pack_bf16(o[4 * jd + 2] / d_hi, o[4 * jd + 3] / d_hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BLOCK_M = 64;                  // query rows per CTA
constexpr int SIMPLE_THREADS = BLOCK_M * 4;  // 4 threads per query row
constexpr int SIMPLE_N = 32;                 // keys per K/V tile

template <int HD>
__global__ void __launch_bounds__(SIMPLE_THREADS)
flash_simple_kernel(const float* __restrict__ q,  // [B, Sq, Hq, HD]
                    const float* __restrict__ k,  // [B, Sk, KVH, HD]
                    const float* __restrict__ v,  // [B, Sk, KVH, HD]
                    float* __restrict__ out,      // [B, Sq, Hq, HD]
                    int Sq, int Sk, int Hq, int KVH, int causal, int window, float sm_scale) {
  constexpr int DPT = HD / 4;  // dimensions per thread: part, part + 4, ...
  __shared__ __align__(16) float ks[SIMPLE_N][HD];
  __shared__ __align__(16) float vs[SIMPLE_N][HD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / KVH);
  const int tid = threadIdx.x, part = tid & 3;
  const int q0 = blockIdx.x * BLOCK_M;
  const int q_last = min(q0 + BLOCK_M, Sq) - 1;
  const int row = q0 + (tid >> 2);
  const size_t q_row = (size_t)Hq * HD, kv_row = (size_t)KVH * HD;
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * HD;
  const size_t q_off = ((size_t)b * Sq + row) * q_row + (size_t)h * HD;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < Sq ? q[q_off + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int2 band = key_band(q0, q_last, Sk, causal, window, SIMPLE_N);
  for (int t0 = band.x; t0 < band.y; t0 += SIMPLE_N) {
    __syncthreads();
    for (int e = tid; e < SIMPLE_N * HD / 4; e += SIMPLE_THREADS) {
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const int key = t0 + j;
      float4 kr = make_float4(0.f, 0.f, 0.f, 0.f), vr = kr;
      if (key < Sk) {
        kr = __ldg(reinterpret_cast<const float4*>(kb + (size_t)key * kv_row + c));
        vr = __ldg(reinterpret_cast<const float4*>(vb + (size_t)key * kv_row + c));
      }
      *reinterpret_cast<float4*>(&ks[j][c]) = kr;
      *reinterpret_cast<float4*>(&vs[j][c]) = vr;
    }
    __syncthreads();

    float s[SIMPLE_N];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < SIMPLE_N; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) d = fmaf(qr[i], ks[j][part + 4 * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = visible(row, t0 + j, Sk, causal, window) ? d * sm_scale : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float mn = fmaxf(m, mt);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SIMPLE_N; ++j) {
      s[j] = visible(row, t0 + j, Sk, causal, window) ? expf(s[j] - mn) : 0.f;
      sum += s[j];
    }
    const float alpha = expf(m - mn);
    l = l * alpha + sum;
    m = mn;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < SIMPLE_N; ++j) a = fmaf(s[j], vs[j][part + 4 * i], a);
      acc[i] = a;
    }
  }

  if (row < Sq) {
    const float d = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[q_off + part + 4 * i] = acc[i] / d;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a 4-D map over bf16 [B, S, H, hd], boxes of one head's `rows` rows x
// `box` columns, zeros past S, swizzled over the box's row bytes (128, 64 or 32)
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
            int rows, int box) {
  const CUtensorMapSwizzle swizzle = box * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool shape_ok(int B, int Sq, int Sk, int Hq, int KVH) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && KVH >= 1 && Hq % KVH == 0;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int Hq, int KVH, int causal, int window, float sm_scale,
                        cudaStream_t s) {
  using L = FaSmem<HD>;
  if (!shape_ok(B, Sq, Sk, Hq, KVH)) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  if (!encode(enc, &qm, q, B, Sq, Hq, HD, FA_M, L::BOX) ||
      !encode(enc, &km, k, B, Sk, KVH, HD, FA_N, L::BOX) ||
      !encode(enc, &vm, v, B, Sk, KVH, HD, FA_N, L::BOX))
    return cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  // one CTA per SM at most, each walking every gridDim-th work tile
  const long long n_work = (long long)((Sq + FA_M - 1) / FA_M) * Hq * B;
  if (n_work > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(n_work < n_sm ? n_work : n_sm);
  flash_wgmma_kernel<HD><<<grid, FA_THREADS, L::BYTES, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, Hq, KVH, causal, window, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                       int Sk, int Hq, int KVH, int causal, int window, float sm_scale,
                       cudaStream_t s) {
  if (!shape_ok(B, Sq, Sk, Hq, KVH)) return cudaErrorInvalidValue;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, Hq, B);
  flash_simple_kernel<HD><<<grid, SIMPLE_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, Hq, KVH, causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int Sq, int Sk, int Hq, int KVH, int hd, int causal,
                                    int window, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_bf16<32>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 64: return launch_bf16<64>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 80: return launch_bf16<80>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 96: return launch_bf16<96>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int Sq, int Sk, int Hq, int KVH, int hd, int causal, int window,
                                   float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 64: return launch_f32<64>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 80: return launch_f32<80>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 96: return launch_f32<96>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 128: return launch_f32<128>(q, k, v, out, B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
