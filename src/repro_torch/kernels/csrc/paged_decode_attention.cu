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
//   * The same walks as decode_attention.cu (`decode_core::attend` at
//     G <= 8, one CTA per (batch row, KV head); `decode_core::attend_g16`
//     and `decode_core::combine_kernel` at G == 16, one CTA per (batch row,
//     KV head, split)): key t of row b is pool row table[b, t / bs] * bs +
//     t % bs.  `bs` is a runtime value (any block size >= 1: the serving
//     tests use 1, 3, 4 and 16), so the address is one integer division per
//     key row.  TMA cannot follow a block table, so the G 16 walk stages its
//     K/V tiles by cp.async, one key row at a time, in both kernels.
//   * The walk covers exactly [0, min(lengths[b], n_logical * bs)), so no
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

using decode_core::G16Smem;
using decode_core::THREADS;

struct PagedRows {
  const int* __restrict__ table;  // this row's n_logical entries
  int bs;
  __device__ __forceinline__ size_t operator()(int key) const {
    return (size_t)__ldg(table + key / bs) * bs + key % bs;
  }
};

template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,       // [B, KVH * G, HD]
                              const __nv_bfloat16* __restrict__ k_pool,  // [NB, bs, KVH, HD]
                              const __nv_bfloat16* __restrict__ v_pool,  // [NB, bs, KVH, HD]
                              const int* __restrict__ table,             // [B, n_logical]
                              const int* __restrict__ lengths,           // [B]
                              __nv_bfloat16* __restrict__ out,           // [B, KVH * G, HD]
                              int n_logical, int bs, int KVH, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = n_logical * bs;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t head = ((size_t)b * KVH + h) * G * HD;  // the G query heads of KV head h
  decode_core::attend<HD, G>(q + head, k_pool + (size_t)h * HD, v_pool + (size_t)h * HD,
                             (size_t)KVH * HD, len, PagedRows{table + (size_t)b * n_logical, bs},
                             out + head, sm_scale);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_g16_kernel(const __nv_bfloat16* __restrict__ q,       // [B, KVH * 16, HD]
                        const __nv_bfloat16* __restrict__ k_pool,  // [NB, bs, KVH, HD]
                        const __nv_bfloat16* __restrict__ v_pool,  // [NB, bs, KVH, HD]
                        const int* __restrict__ table,             // [B, n_logical]
                        const int* __restrict__ lengths,           // [B]
                        __nv_bfloat16* __restrict__ out,           // [B, KVH * 16, HD]
                        float* __restrict__ part_o,    // [B, KVH, n_split_max, 16, HD]
                        float* __restrict__ part_lse,  // [B, KVH, n_split_max, 16]
                        int n_logical, int bs, int KVH, int split, int n_split_max,
                        float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = n_logical * bs;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t bh = (size_t)b * KVH + h;
  const size_t head = bh * decode_core::MMA_G * HD;
  decode_core::attend_g16<HD>(q + head, k_pool + (size_t)h * HD, v_pool + (size_t)h * HD,
                              (size_t)KVH * HD, len, split, blockIdx.z,
                              PagedRows{table + (size_t)b * n_logical, bs}, out + head,
                              part_o + bh * n_split_max * decode_core::MMA_G * HD,
                              part_lse + bh * n_split_max * decode_core::MMA_G, sm_scale, smem);
}

// G <= 8; `part_o`, `part_lse`, `split` and `combine` are for G == 16 only
template <int HD, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* lengths, void* out, void*, void*, int B,
                         int n_logical, int bs, int KVH, int, int, float sm_scale,
                         cudaStream_t s) {
    paged_decode_attention_kernel<HD, G><<<dim3(KVH, B), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), n_logical, bs, KVH,
        sm_scale);
    return cudaGetLastError();
  }
};

// G == 16: as in decode_attention.cu, over S = n_logical * bs
template <int HD>
struct Launch<HD, 16> {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* lengths, void* out, void* part_o,
                         void* part_lse, int B, int n_logical, int bs, int KVH, int split,
                         int combine, float sm_scale, cudaStream_t s) {
    const int S = n_logical * bs;
    if (split < decode_core::WT || split % decode_core::WT != 0 || B > 65535)
      return cudaErrorInvalidValue;
    const int n_split_max = decode_core::n_splits(S, split);
    if (n_split_max > 65535 || (n_split_max > 1 && (part_o == nullptr || part_lse == nullptr)))
      return cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t err =
          cudaFuncSetAttribute(paged_decode_g16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G16Smem<HD>::BYTES);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    paged_decode_g16_kernel<HD><<<dim3(KVH, B, n_split_max), THREADS, G16Smem<HD>::BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(part_o), static_cast<float*>(part_lse), n_logical, bs, KVH, split,
        n_split_max, sm_scale);
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

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* table, const void* lengths, void* out,
                                           void* part_o, void* part_lse, int B, int n_logical,
                                           int bs, int KVH, int G, int hd, int split, int combine,
                                           float sm_scale, void* stream) {
  if (bs < 1 || n_logical < 1) return cudaErrorInvalidValue;
  return decode_core::dispatch<Launch>(hd, G, q, k_pool, v_pool, table, lengths, out, part_o,
                                       part_lse, B, n_logical, bs, KVH, split, combine, sm_scale,
                                       reinterpret_cast<cudaStream_t>(stream));
}
