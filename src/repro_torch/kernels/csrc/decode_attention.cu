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
// Design: the walk in decode_attention_core.cuh, shared with the paged
// kernel, for every G from 1 (stablelm-1.6b) to 16 (glm4-9b): one CTA of 4
// warps per (batch row, KV head, split of `split` keys) on the tensor cores
// (`decode_core::attend`), and a second small kernel
// (`decode_core::combine_kernel`) that adds the splits of the rows that have
// more than one.  It is launched only when S > split, since no row can have
// two splits otherwise.  The caller allocates the splits' scratch.  Key t of
// row b is cache row b * S + t; the walk reads no key at or past the row's
// length, clamped to S.  Head dims 32, 64, 80 (zamba2-2.7b: five k-steps
// of Q K^T and ten 8-dim column blocks of P V, paired) and 128.
//
// Optional outputs (null pointers: not written, the walk as before): each
// query row's output in f32 before its bf16 cast, `out_f32` [B, KVH * G,
// HD], and its log-sum-exp `lse` [B, KVH * G] (-inf at length 0).  They are
// the partial of one sequence shard when the cache is split over devices:
// the shards' (out_f32, lse) are combined as the walk combines its splits
// (kernels/decode_attention.py, `decode_attention_partial`).  A null `out`
// writes no bf16 output.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"

namespace {

struct DenseRows {
  size_t base;  // b * S
  struct Tile {
    size_t first;  // the cache row of the tile's first key
  };
  __device__ __forceinline__ Tile tile(int key0, int, int) const { return {base + key0}; }
  __device__ __forceinline__ size_t operator()(const Tile& t, int, int r) const {
    return t.first + r;
  }
};

template <int HD>
__global__ void __launch_bounds__(decode_core::THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, KVH * G, HD]
                        const __nv_bfloat16* __restrict__ k,  // [B, S, KVH, HD]
                        const __nv_bfloat16* __restrict__ v,  // [B, S, KVH, HD]
                        const int* __restrict__ lengths,      // [B]
                        __nv_bfloat16* __restrict__ out,      // [B, KVH * G, HD]
                        float* __restrict__ part_o,           // [B, KVH, n_split_max, G, HD]
                        float* __restrict__ part_lse,         // [B, KVH, n_split_max, G]
                        float* __restrict__ out_f32,          // [B, KVH * G, HD] or null
                        float* __restrict__ lse,              // [B, KVH * G] or null
                        int S, int KVH, int G, int split, float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t bh = (size_t)b * KVH + h;
  const size_t head = bh * G * HD;  // the G query heads of KV head h
  const size_t part = bh * gridDim.z * G;
  decode_core::attend<HD>(q + head, k + (size_t)h * HD, v + (size_t)h * HD, (size_t)KVH * HD, len,
                          G, split, blockIdx.z, DenseRows{(size_t)b * S},
                          out != nullptr ? out + head : nullptr, part_o + part * HD,
                          part_lse + part, out_f32 != nullptr ? out_f32 + head : nullptr,
                          lse != nullptr ? lse + bh * G : nullptr, sm_scale, smem);
}

template <int HD>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const void* lengths,
                         void* out, void* part_o, void* part_lse, void* out_f32, void* lse, int B,
                         int S, int KVH, int G, int split, int combine, float sm_scale,
                         cudaStream_t s) {
    return decode_core::launch_walk<HD>(
        decode_attention_kernel<HD>, lengths, out, part_o, part_lse, out_f32, lse, B, S, KVH, G,
        split, combine, s, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(part_o), static_cast<float*>(part_lse), static_cast<float*>(out_f32),
        static_cast<float*>(lse), S, KVH, G, split, sm_scale);
  }
};

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* part_o, void* part_lse,
                                     void* out_f32, void* lse, int B, int S, int KVH, int G,
                                     int hd, int split, int combine, float sm_scale,
                                     void* stream) {
  return decode_core::dispatch<Launch>(hd, q, k, v, lengths, out, part_o, part_lse, out_f32, lse,
                                       B, S, KVH, G, split, combine, sm_scale,
                                       reinterpret_cast<cudaStream_t>(stream));
}
