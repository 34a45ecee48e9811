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
//   * One CTA of 128 threads per (batch row, KV head) (two at G = 16, each
//     with 8 query heads, as in the dense kernel), the same walk as
//     decode_attention.cu (`decode_core::attend`): key t of row b is pool
//     row table[b, t / bs] * bs + t % bs.  `bs` is a runtime value (any
//     block size >= 1: the serving tests use 1, 3, 4 and 16), so the address
//     is one integer division per key load.
//   * The walk covers exactly [0, min(lengths[b], n_logical * bs)), so no
//     table column at or past n_logical is read, and the tiles,
//     reductions and roundings are those of the dense kernel: on the same
//     logical cache the two kernels give bitwise equal outputs.  Table
//     entries past a row's length (the trash block) are never dereferenced.
//   * A row of length 0 returns zeros.
//   * Split-K over the sequence and TMA for the block stream are later work.
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
  __device__ __forceinline__ size_t operator()(int key) const {
    return (size_t)__ldg(table + key / bs) * bs + key % bs;
  }
};

template <int HD, int G>
__global__ void __launch_bounds__(decode_core::THREADS)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,       // [B, KVH * G, HD]
                              const __nv_bfloat16* __restrict__ k_pool,  // [NB, bs, KVH, HD]
                              const __nv_bfloat16* __restrict__ v_pool,  // [NB, bs, KVH, HD]
                              const int* __restrict__ table,             // [B, n_logical]
                              const int* __restrict__ lengths,           // [B]
                              __nv_bfloat16* __restrict__ out,           // [B, KVH * G, HD]
                              int n_logical, int bs, int KVH, float sm_scale) {
  using Split = decode_core::Split<G>;
  const int h = blockIdx.x / Split::NS;
  const int b = blockIdx.y;
  const int S = n_logical * bs;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  // this CTA's GC query heads of KV head h
  const size_t head = (((size_t)b * KVH + h) * G + (blockIdx.x % Split::NS) * Split::GC) * HD;
  decode_core::attend<HD, Split::GC>(q + head, k_pool + (size_t)h * HD,
                                     v_pool + (size_t)h * HD, (size_t)KVH * HD, len,
                                     PagedRows{table + (size_t)b * n_logical, bs}, out + head,
                                     sm_scale);
}

template <int HD, int G>
struct Launch {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* lengths, void* out, int B,
                         int n_logical, int bs, int KVH, float sm_scale, cudaStream_t s) {
    dim3 grid(KVH * decode_core::Split<G>::NS, B);
    paged_decode_attention_kernel<HD, G><<<grid, decode_core::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), n_logical, bs, KVH,
        sm_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* table, const void* lengths, void* out,
                                           int B, int n_logical, int bs, int KVH, int G, int hd,
                                           float sm_scale, void* stream) {
  if (bs < 1 || n_logical < 1) return cudaErrorInvalidValue;
  return decode_core::dispatch<Launch>(hd, G, q, k_pool, v_pool, table, lengths, out, B,
                                       n_logical, bs, KVH, sm_scale,
                                       reinterpret_cast<cudaStream_t>(stream));
}
