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
//     stablelm-1.6b's serve shapes; at G = 16 (glm4-9b) two CTAs per KV
//     head, each with 8 of its query heads (`decode_core::Split`).  The
//     CTA walks [0, lengths[b]) in tiles of 128 keys and never reads past
//     the row's length (clamped to S).
//   * The CTA's query heads share every K/V row it loads (G is a template
//     parameter, as is hd: 32, 64 or 128).
//   * The walk itself (16-byte loads, scores by warp shuffles, online softmax
//     in f32, P.V in registers) is `decode_core::attend` in
//     decode_attention_core.cuh, shared with the paged kernel; key t of row
//     b is cache row b * S + t.
//   * Split-K over the sequence, TMA and wgmma are later work.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"

namespace {

struct DenseRows {
  size_t base;  // b * S
  __device__ __forceinline__ size_t operator()(int key) const { return base + key; }
};

template <int HD, int G>
__global__ void __launch_bounds__(decode_core::THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, KVH * G, HD]
                        const __nv_bfloat16* __restrict__ k,  // [B, S, KVH, HD]
                        const __nv_bfloat16* __restrict__ v,  // [B, S, KVH, HD]
                        const int* __restrict__ lengths,      // [B]
                        __nv_bfloat16* __restrict__ out,      // [B, KVH * G, HD]
                        int S, int KVH, float sm_scale) {
  using Split = decode_core::Split<G>;
  const int h = blockIdx.x / Split::NS;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  // this CTA's GC query heads of KV head h
  const size_t head = (((size_t)b * KVH + h) * G + (blockIdx.x % Split::NS) * Split::GC) * HD;
  decode_core::attend<HD, Split::GC>(q + head, k + (size_t)h * HD, v + (size_t)h * HD,
                                     (size_t)KVH * HD, len, DenseRows{(size_t)b * S}, out + head,
                                     sm_scale);
}

template <int HD, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const void* lengths,
                         void* out, int B, int S, int KVH, float sm_scale, cudaStream_t s) {
    dim3 grid(KVH * decode_core::Split<G>::NS, B);
    decode_attention_kernel<HD, G><<<grid, decode_core::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), S, KVH, sm_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, int B, int S, int KVH, int G,
                                     int hd, float sm_scale, void* stream) {
  return decode_core::dispatch<Launch>(hd, G, q, k, v, lengths, out, B, S, KVH, sm_scale,
                                       reinterpret_cast<cudaStream_t>(stream));
}
