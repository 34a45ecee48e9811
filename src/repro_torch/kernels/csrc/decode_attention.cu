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
// Design (the walks themselves are in decode_attention_core.cuh, shared
// with the paged kernel; key t of row b is cache row b * S + t; every walk
// reads no key at or past the row's length, clamped to S):
//   * G <= 8 (stablelm-1.6b: G 1): one CTA of 128 threads per (batch row,
//     KV head), 8 x 32 = 256 CTAs at stablelm's serve shapes, walking
//     [0, lengths[b]) in tiles of 128 keys on the CUDA cores
//     (`decode_core::attend`); the G query heads share every K/V row it
//     loads.
//   * G == 16 (glm4-9b): one CTA of 4 warps per (batch row, KV head, split
//     of `split` keys) on the tensor cores (`decode_core::attend_g16`), and
//     a second small kernel (`decode_core::combine_kernel`) that adds the
//     splits of the rows that have more than one.  It is launched only when
//     S > split, since no row can have two splits otherwise.  The caller
//     allocates the splits' scratch.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"

namespace {

using decode_core::G16Smem;
using decode_core::THREADS;

struct DenseRows {
  size_t base;  // b * S
  __device__ __forceinline__ size_t operator()(int key) const { return base + key; }
};

template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, KVH * G, HD]
                        const __nv_bfloat16* __restrict__ k,  // [B, S, KVH, HD]
                        const __nv_bfloat16* __restrict__ v,  // [B, S, KVH, HD]
                        const int* __restrict__ lengths,      // [B]
                        __nv_bfloat16* __restrict__ out,      // [B, KVH * G, HD]
                        int S, int KVH, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t head = ((size_t)b * KVH + h) * G * HD;  // the G query heads of KV head h
  decode_core::attend<HD, G>(q + head, k + (size_t)h * HD, v + (size_t)h * HD, (size_t)KVH * HD,
                             len, DenseRows{(size_t)b * S}, out + head, sm_scale);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_g16_kernel(const __nv_bfloat16* __restrict__ q,  // [B, KVH * 16, HD]
                  const __nv_bfloat16* __restrict__ k,  // [B, S, KVH, HD]
                  const __nv_bfloat16* __restrict__ v,  // [B, S, KVH, HD]
                  const int* __restrict__ lengths,      // [B]
                  __nv_bfloat16* __restrict__ out,      // [B, KVH * 16, HD]
                  float* __restrict__ part_o,           // [B, KVH, n_split_max, 16, HD]
                  float* __restrict__ part_lse,         // [B, KVH, n_split_max, 16]
                  int S, int KVH, int split, int n_split_max, float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t bh = (size_t)b * KVH + h;
  const size_t head = bh * decode_core::MMA_G * HD;
  decode_core::attend_g16<HD>(q + head, k + (size_t)h * HD, v + (size_t)h * HD, (size_t)KVH * HD,
                              len, split, blockIdx.z, DenseRows{(size_t)b * S}, out + head,
                              part_o + bh * n_split_max * decode_core::MMA_G * HD,
                              part_lse + bh * n_split_max * decode_core::MMA_G, sm_scale, smem);
}

// G <= 8; `part_o`, `part_lse`, `split` and `combine` are for G == 16 only
template <int HD, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, const void* lengths,
                         void* out, void*, void*, int B, int S, int KVH, int, int, float sm_scale,
                         cudaStream_t s) {
    decode_attention_kernel<HD, G><<<dim3(KVH, B), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), S, KVH, sm_scale);
    return cudaGetLastError();
  }
};

// G == 16: the walk over (KV head, row, split), then the combine where a
// row can have more than one split (`combine` 0 leaves it out: a planted
// fault for the tests, never the wrapper's call)
template <int HD>
struct Launch<HD, 16> {
  static cudaError_t run(const void* q, const void* k, const void* v, const void* lengths,
                         void* out, void* part_o, void* part_lse, int B, int S, int KVH,
                         int split, int combine, float sm_scale, cudaStream_t s) {
    if (split < decode_core::WT || split % decode_core::WT != 0 || B > 65535)
      return cudaErrorInvalidValue;
    const int n_split_max = decode_core::n_splits(S, split);
    if (n_split_max > 65535 || (n_split_max > 1 && (part_o == nullptr || part_lse == nullptr)))
      return cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_g16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, G16Smem<HD>::BYTES);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    decode_g16_kernel<HD><<<dim3(KVH, B, n_split_max), THREADS, G16Smem<HD>::BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
        static_cast<float*>(part_lse), S, KVH, split, n_split_max, sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split_max == 1 || !combine) return err;
    decode_core::combine_kernel<HD><<<dim3(KVH, B, decode_core::MMA_G), HD, 0, s>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), S, KVH, split,
        n_split_max);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* part_o, void* part_lse,
                                     int B, int S, int KVH, int G, int hd, int split, int combine,
                                     float sm_scale, void* stream) {
  return decode_core::dispatch<Launch>(hd, G, q, k, v, lengths, out, part_o, part_lse, B, S, KVH,
                                       split, combine, sm_scale,
                                       reinterpret_cast<cudaStream_t>(stream));
}
