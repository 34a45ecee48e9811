// Flash-decode through a block table for Hopper (sm_90a): one query token
// per batch row against a PAGED KV cache, a pool of [NB, bs, KVH, hd]
// blocks addressed by a per-row table [B, n_logical], masked by per-row
// lengths, online softmax.
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
// `paged_decode_attention` (Pallas body `_paged_decode_kernel`).
//
// Bound on an H100: bytes, as for the dense kernel.  Each valid K and V row
// is read once (2 x len x hd x 2 B per (row, KV head)), plus one table entry
// per block the row covers; the arithmetic is two multiply-adds per element
// read per query head.
//
// Design:
//   * The walk of decode_attention.cu (`decode_core::attend`, one CTA per
//     (batch row, KV head, split), and `decode_core::combine_kernel`): key t
//     of row b is pool row table[b, t / bs] * bs + t % bs.  `bs` is a
//     runtime value (any block size >= 1: the serving tests use 1, 3, 4 and
//     16).  TMA cannot follow a block table, so the walk stages its K/V
//     tiles by cp.async, one key row at a time, in both kernels.
//   * The table is read once per 32-key warp tile: lane l loads the entry of
//     the tile's l-th block (at most 32 blocks, one coalesced load), and
//     each key row's address takes its entry by a shuffle, for K and V
//     alike.
//   * The walk covers exactly [0, min(lengths[b], S)), where S <= n_logical
//     * bs is the length of each row's view (the wrapper's `seq_len`), so no
//     table column at or past n_logical is read, and the tiles,
//     reductions and roundings are those of the dense kernel: on the same
//     logical cache the two kernels give bitwise equal outputs.  Table
//     entries past a row's length (the trash block) are never dereferenced.
//   * A row of length 0 returns zeros.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"

namespace {

struct PagedRows {
  const int* __restrict__ table;  // this row's n_logical entries
  int bs;
  struct Tile {
    int entry;  // lane l: the pool block of the tile's l-th block
    int blk0;   // the tile's first logical block
  };
  // every lane of the warp calls both, with the same key0
  __device__ __forceinline__ Tile tile(int key0, int n_keys, int lane) const {
    const int blk0 = key0 / bs;
    const int n_blk = (key0 + n_keys - 1) / bs - blk0 + 1;  // <= 32: a tile holds 32 keys
    return {lane < n_blk ? __ldg(table + blk0 + lane) : 0, blk0};
  }
  __device__ __forceinline__ size_t operator()(const Tile& t, int key0, int r) const {
    const int key = key0 + r, blk = key / bs;
    const int entry = __shfl_sync(0xffffffffu, t.entry, (blk - t.blk0) & 31);
    return (size_t)entry * bs + (key - blk * bs);
  }
};

template <int HD>
__global__ void __launch_bounds__(decode_core::THREADS)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,       // [B, KVH * G, HD]
                              const __nv_bfloat16* __restrict__ k_pool,  // [NB, bs, KVH, HD]
                              const __nv_bfloat16* __restrict__ v_pool,  // [NB, bs, KVH, HD]
                              const int* __restrict__ table,             // [B, n_logical]
                              const int* __restrict__ lengths,           // [B]
                              __nv_bfloat16* __restrict__ out,           // [B, KVH * G, HD]
                              float* __restrict__ part_o,    // [B, KVH, n_split_max, G, HD]
                              float* __restrict__ part_lse,  // [B, KVH, n_split_max, G]
                              int n_logical, int bs, int S, int KVH, int G, int split,
                              float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t bh = (size_t)b * KVH + h;
  const size_t head = bh * G * HD;  // the G query heads of KV head h
  const size_t part = bh * gridDim.z * G;
  decode_core::attend<HD>(q + head, k_pool + (size_t)h * HD, v_pool + (size_t)h * HD,
                          (size_t)KVH * HD, len, G, split, blockIdx.z,
                          PagedRows{table + (size_t)b * n_logical, bs}, out + head,
                          part_o + part * HD, part_lse + part, nullptr, nullptr, sm_scale, smem);
}

// as in decode_attention.cu, over a view of S <= n_logical * bs positions
template <int HD>
struct Launch {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* lengths, void* out, void* part_o,
                         void* part_lse, int B, int n_logical, int bs, int S, int KVH, int G,
                         int split, int combine, float sm_scale, cudaStream_t s) {
    return decode_core::launch_walk<HD>(
        paged_decode_attention_kernel<HD>, lengths, out, part_o, part_lse, nullptr, nullptr, B, S,
        KVH, G, split, combine, s, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(table), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
        static_cast<float*>(part_lse), n_logical, bs, S, KVH, G, split, sm_scale);
  }
};

}  // namespace

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* table, const void* lengths, void* out,
                                           void* part_o, void* part_lse, int B, int n_logical,
                                           int bs, int S, int KVH, int G, int hd, int split,
                                           int combine, float sm_scale, void* stream) {
  if (bs < 1 || n_logical < 1 || S < 0 || S > n_logical * bs) return cudaErrorInvalidValue;
  return decode_core::dispatch<Launch>(hd, q, k_pool, v_pool, table, lengths, out, part_o,
                                       part_lse, B, n_logical, bs, S, KVH, G, split, combine,
                                       sm_scale, reinterpret_cast<cudaStream_t>(stream));
}
