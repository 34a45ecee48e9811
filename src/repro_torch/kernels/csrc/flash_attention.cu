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
// Bound on an H100, at the port's shapes (bf16, 32 heads of 64):
//   * stablelm-1.6b's first prefill batch, B 8, S 104: 13.6 MB of q, k, v
//     and out against 0.36 GFLOP of causal products, so BYTES: 0.0041 ms at
//     3.35 TB/s (the FLOPs take 0.0004 ms at 989 TFLOP/s);
//   * one 2048-token prompt: 17.2 GFLOP of causal products against 33.6 MB,
//     so OPERATIONS: 0.0174 ms (the bytes take 0.0100 ms).
//
// Design (bf16, `flash_mma_kernel`):
//   * One CTA of 4 warps per (query tile of 64 rows, query head, batch row);
//     each warp owns 16 query rows.  The Pallas grid's sequential KV axis,
//     whose (m, l, acc) lives in VMEM, becomes a loop inside the CTA with
//     m and l in registers and acc in the tensor-core accumulators.
//   * Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate): Q's fragments are loaded once from device memory into
//     registers; K/V tiles of 64 keys are staged in shared memory (16-byte
//     loads, rows padded by 16 bytes so the fragment reads hit 32 distinct
//     banks; V is read transposed with ldmatrix.trans); the score
//     accumulators are rescaled and rounded to bf16 in registers and reused
//     directly as the A operand of P.V, so P never touches shared memory.
//   * The loop runs over the key tiles of the band only: from the window
//     bound of the tile's first row (rounded down to a tile) to the causal
//     bound of its last row, so whole tiles outside the causal or window
//     band are neither loaded nor computed.  Keys at or past Sk are loaded
//     as zeros and masked; query rows past Sq are computed on zeros and
//     never stored.  The wrapper pads nothing.
//   * A row's result does not depend on B, Sq or its place in the batch:
//     key tiles start at absolute positions (multiples of 64) and are
//     reduced in a fixed order; a tile that is fully masked for a row leaves
//     its m, l and acc bitwise unchanged (alpha is exactly 1, p exactly 0).
//   * Against the bound: at the serve's shapes the kernel reads each K/V
//     tile once per query tile and head (K/V re-reads come from L2), so it
//     is near the byte bound only if the tiles' loads overlap the products;
//     they do not here (no cp.async/TMA pipeline), and at 2048 tokens
//     mma.sync reaches a fraction of the wgmma rate.  TMA, wgmma and warp
//     specialisation (the FA3 design) are later work.
//
// f32 (`flash_simple_kernel`, the tests' sweep; not on the serve's path):
// one CTA of 256 threads per (64 query rows, head, batch row), 4 threads
// per row each owning every 4th dimension; K/V tiles of 32 keys in shared
// memory as f32; scores by FMAs and quad shuffles.  The same band, masks,
// online softmax and output rule.
//
// Each exported function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_M = 64;  // query rows per CTA

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;  // 16 query rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int BLOCK_N = 64;  // keys per K/V tile

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * quad + qi): A holds rows quad
// and quad + 8, columns 2 qi (+1) and 2 qi + 8 (+1); B holds columns (n)
// quad, rows (k) 2 qi (+1) and 2 qi + 8 (+1); C holds rows quad and quad + 8,
// columns 2 qi (+1).  The lower column or row sits in the low half.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Sq, Hq, HD]
                 const __nv_bfloat16* __restrict__ k,  // [B, Sk, KVH, HD]
                 const __nv_bfloat16* __restrict__ v,  // [B, Sk, KVH, HD]
                 __nv_bfloat16* __restrict__ out,      // [B, Sq, Hq, HD]
                 int Sq, int Sk, int Hq, int KVH, int causal, int window, float sm_scale) {
  static_assert(HD % 16 == 0 && (HD / 8) % 2 == 0, "k-steps of 16, V fragments in pairs");
  constexpr int PITCH = HD + 8;  // smem row pitch in bf16: 16 bytes of padding
  constexpr int NT = BLOCK_N / 8;  // score fragments (8 keys each) per warp
  constexpr int DT = HD / 8;       // output fragments (8 dims each) per warp
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_N * PITCH];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_N * PITCH];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, qi = lane & 3;
  const int q0 = blockIdx.x * BLOCK_M;
  const int q_last = min(q0 + BLOCK_M, Sq) - 1;
  const size_t q_row = (size_t)Hq * HD, kv_row = (size_t)KVH * HD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * HD;
  const int r_lo = q0 + warp * 16 + quad, r_hi = r_lo + 8;

  // Q's A fragments, once, straight from device memory; rows past Sq are 0
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + qi * 2;
    qf[kk][0] = r_lo < Sq ? ld32(qb + r_lo * q_row + c) : 0u;
    qf[kk][1] = r_hi < Sq ? ld32(qb + r_hi * q_row + c) : 0u;
    qf[kk][2] = r_lo < Sq ? ld32(qb + r_lo * q_row + c + 8) : 0u;
    qf[kk][3] = r_hi < Sq ? ld32(qb + r_hi * q_row + c + 8) : 0u;
  }
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  const int2 band = key_band(q0, q_last, Sk, causal, window, BLOCK_N);
  for (int t0 = band.x; t0 < band.y; t0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int CHUNKS = HD / 8;  // 16-byte chunks per key row
    for (int e = tid; e < BLOCK_N * CHUNKS; e += MMA_THREADS) {
      const int j = e / CHUNKS, c = (e % CHUNKS) * 8;
      const int key = t0 + j;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (key < Sk) {
        kr = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)key * kv_row + c));
        vr = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)key * kv_row + c));
      }
      *reinterpret_cast<uint4*>(ks + j * PITCH + c) = kr;
      *reinterpret_cast<uint4*>(vs + j * PITCH + c) = vr;
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + quad) * PITCH + kk * 16 + qi * 2;
        mma_bf16(s[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale and mask; the row maxima over the quad's 4 lanes
    uint32_t vis = 0u;
    float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + j * 8 + qi * 2 + (e & 1);
        const bool ok = visible(e < 2 ? r_lo : r_hi, key, Sk, causal, window);
        vis |= (uint32_t)ok << (j * 4 + e);
        s[j][e] = ok ? s[j][e] * sm_scale : NEG_INF;
        if (e < 2) mt_lo = fmaxf(mt_lo, s[j][e]);
        else mt_hi = fmaxf(mt_hi, s[j][e]);
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
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (j * 4 + e) & 1u) ? expf(s[j][e] - (e < 2 ? mn_lo : mn_hi)) : 0.f;
        s[j][e] = p;
        if (e < 2) sum_lo += p;
        else sum_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= a_lo;
      o[j][1] *= a_lo;
      o[j][2] *= a_hi;
      o[j][3] *= a_hi;
    }

    // O += P V: the score fragments of keys [16 kk, 16 kk + 16), rounded to
    // bf16, are the A fragment; V's B fragments by ldmatrix.trans, two
    // 8-dim column blocks per call
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        // lanes 0-15: keys 16 kk + (lane & 15) at dims 8 j; lanes 16-31: dims 8 (j + 1)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 15)) * PITCH + (j + (lane >> 4)) * 8);
        mma_bf16(o[j], a, bv[0], bv[1]);
        mma_bf16(o[j + 1], a, bv[2], bv[3]);
      }
    }
  }

  const float d_lo = l_lo > 0.f ? l_lo : 1.f, d_hi = l_hi > 0.f ? l_hi : 1.f;
  __nv_bfloat16* ob = out + (size_t)b * Sq * q_row + (size_t)h * HD + qi * 2;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(ob + r_lo * q_row + j * 8) =
          pack_bf16(o[j][0] / d_lo, o[j][1] / d_lo);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(ob + r_hi * q_row + j * 8) =
          pack_bf16(o[j][2] / d_hi, o[j][3] / d_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

template <class T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, int, int,
                                  float), int threads, const void* q, const void* k, const void* v,
                   void* out, int B, int Sq, int Sk, int Hq, int KVH, int causal, int window,
                   float sm_scale, cudaStream_t s) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || Hq % KVH != 0) return cudaErrorInvalidValue;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, Hq, B);
  kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                  static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, KVH,
                                  causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int Sq, int Sk, int Hq, int KVH, int hd, int causal,
                                    int window, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<__nv_bfloat16>(flash_mma_kernel<32>, MMA_THREADS, q, k, v, out, B,
                                              Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 64: return launch<__nv_bfloat16>(flash_mma_kernel<64>, MMA_THREADS, q, k, v, out, B,
                                              Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 128: return launch<__nv_bfloat16>(flash_mma_kernel<128>, MMA_THREADS, q, k, v, out,
                                                B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int Sq, int Sk, int Hq, int KVH, int hd, int causal, int window,
                                   float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<float>(flash_simple_kernel<32>, SIMPLE_THREADS, q, k, v, out, B,
                                      Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 64: return launch<float>(flash_simple_kernel<64>, SIMPLE_THREADS, q, k, v, out, B,
                                      Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    case 128: return launch<float>(flash_simple_kernel<128>, SIMPLE_THREADS, q, k, v, out,
                                        B, Sq, Sk, Hq, KVH, causal, window, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
