// Fused early-exit head for Hopper (sm_90a): (top-1 softmax probability,
// argmax) of h @ w without writing the [B, V] logits.
//
// Replaces: src/repro/kernels/exit_confidence.py, `exit_confidence`
// (Pallas body `_exit_kernel`).
//
// Bound on an H100: bytes.  One pass over w [d, V] bf16 is the whole cost
// (2048 x 100352 x 2 B = 411 MB at stablelm-1.6b's width, about 123 us at
// 3.35 TB/s); the products are B x d x V multiply-adds, about 3 us of
// tensor-core time at B = 8.
//
// Design:
//   * Pass 1 (`exit_tile_kernel`): the CTAs split the VOCAB, one CTA per
//     256-column tile (392 tiles at V = 100352, about three per SM), and
//     each covers up to 8 batch rows (grid.y covers more).  The eight warps
//     split d; each lane streams 8 consecutive columns of a w row with one
//     16-byte load, so a warp reads 512 contiguous bytes per row.  The h
//     rows sit in shared memory transposed to [d][8] bf16, so one 16-byte
//     shared read gives every row's h[k].  Products accumulate in f32 on
//     the CUDA cores (B x 8 per lane): the loop is limited by the loads, not
//     the multiply-adds.  The warps' partial sums are added in warp order in
//     shared memory; then each thread owns one column for all rows, and the
//     CTA reduces (max, first argmax, sum of exp(logit - max)) per row into
//     one partial per (row, tile).
//   * Pass 2 (`exit_combine_kernel`): one warp per row combines the tiles in
//     index order (a contiguous run per lane, then a butterfly in which the
//     lower lane is always the left operand).  A later tile takes the
//     argmax only if its max is strictly greater, and within a tile the
//     first index wins, so ties resolve to the first index as in the
//     reference.  conf = 1 / l with the l > 0 guard.
//   * Padded batch rows are independent rows: they never touch real ones.
//     Columns past V are masked to -1e30 and never loaded; V need not be a
//     multiple of the tile.  The 16-byte loads need V % 8 == 0 and a 16-byte
//     aligned w (every vocab in the registry is a multiple of 8, and the LM
//     head is its own allocation); the entry point refuses anything else.
//
// Each exported function returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_V = 256;  // vocab columns per CTA
constexpr int ROWS = 8;      // batch rows per CTA
constexpr int WARPS = 8;     // warps per CTA, each a slice of d
constexpr int THREADS = WARPS * 32;
constexpr int CPT = 8;  // columns per thread: one 16-byte load of bf16
constexpr float NEG_INF = -1e30f;

static_assert(TILE_V == THREADS, "after the warp reduction each thread owns one column");
static_assert(TILE_V == 32 * CPT, "a warp covers the tile");

// the 8 columns [c, c + 8) of row k of w; V % 8 == 0, so they are all valid
// or all past V
__device__ __forceinline__ void load_w(const __nv_bfloat16* __restrict__ w, int k, int c,
                                       int V, float (&out)[CPT]) {
  if (c < V) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * V + c));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < CPT / 2; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[j] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
exit_tile_kernel(const __nv_bfloat16* __restrict__ h,  // [B, d]
                 const __nv_bfloat16* __restrict__ w,  // [d, V]
                 float* __restrict__ part_m,           // [B, nt]
                 float* __restrict__ part_l,           // [B, nt]
                 int* __restrict__ part_i,             // [B, nt]
                 int B, int d, int V, int nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_m[WARPS][ROWS];
  __shared__ int s_i[WARPS][ROWS];
  __shared__ float s_l[WARPS][ROWS];
  __shared__ float s_rowmax[ROWS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.y * ROWS;
  const int tile = blockIdx.x;
  const int col0 = tile * TILE_V;

  // h rows of this CTA, transposed to [d][ROWS]; rows past B are zeros
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);
  for (int i = tid; i < d * ROWS; i += THREADS) {
    const int k = i / ROWS, r = i % ROWS;
    h_s[i] = (row0 + r < B) ? h[(size_t)(row0 + r) * d + k] : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[ROWS][CPT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;

  const int c = col0 + lane * CPT;
#pragma unroll 4
  for (int k = warp; k < d; k += WARPS) {
    float wv[CPT];
    load_w(w, k, c, V, wv);
    const uint4 hraw = *reinterpret_cast<const uint4*>(h_s + (size_t)k * ROWS);
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&hraw);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float hr = __bfloat162float(hv[r]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(hr, wv[j], acc[r][j]);
    }
  }
  __syncthreads();  // every warp is done with h_s: the buffer now holds the partial sums

  float* red = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][TILE_V]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + ((size_t)warp * ROWS + r) * TILE_V + lane * CPT);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();

  const int col = col0 + tid;
  float logit[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float s = 0.f;
#pragma unroll
    for (int wg = 0; wg < WARPS; ++wg) s += red[((size_t)wg * ROWS + r) * TILE_V + tid];
    logit[r] = (col < V) ? s : NEG_INF;
  }

  // per-row max with the first index on ties
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float m = logit[r];
    int ix = col;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      if (om > m || (om == m && oi < ix)) {
        m = om;
        ix = oi;
      }
    }
    if (lane == 0) {
      s_m[warp][r] = m;
      s_i[warp][r] = ix;
    }
  }
  __syncthreads();
  if (tid < ROWS) {
    float m = s_m[0][tid];
    int ix = s_i[0][tid];
    for (int wg = 1; wg < WARPS; ++wg) {  // warps cover ascending columns
      if (s_m[wg][tid] > m) {
        m = s_m[wg][tid];
        ix = s_i[wg][tid];
      }
    }
    s_rowmax[tid] = m;
    s_i[0][tid] = ix;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float e = (col < V) ? expf(logit[r] - s_rowmax[r]) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
    if (lane == 0) s_l[warp][r] = e;
  }
  __syncthreads();
  if (tid < ROWS && row0 + tid < B) {
    float l = 0.f;
    for (int wg = 0; wg < WARPS; ++wg) l += s_l[wg][tid];
    const size_t o = (size_t)(row0 + tid) * nt + tile;
    part_m[o] = s_rowmax[tid];
    part_l[o] = l;
    part_i[o] = s_i[0][tid];
  }
}

// (m, l, idx) of the left run of tiles combined with the right run
__device__ __forceinline__ void combine(float& m, float& l, int& ix, float om, float ol, int oi) {
  const float mn = fmaxf(m, om);
  l = l * expf(m - mn) + ol * expf(om - mn);
  if (om > m) ix = oi;  // the right run wins only if strictly greater
  m = mn;
}

__global__ void exit_combine_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ conf, int* __restrict__ idx, int nt) {
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
  }
}

}  // namespace

extern "C" int exit_confidence_bf16(const void* h, const void* w, void* part_m, void* part_l,
                                    void* part_i, void* conf, void* idx, int B, int d, int V,
                                    void* stream) {
  const int nt = (V + TILE_V - 1) / TILE_V;
  const size_t h_bytes = (size_t)d * ROWS * sizeof(__nv_bfloat16);
  const size_t red_bytes = (size_t)WARPS * ROWS * TILE_V * sizeof(float);
  const size_t smem = h_bytes > red_bytes ? h_bytes : red_bytes;
  if (V % CPT != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(exit_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(nt, (B + ROWS - 1) / ROWS);
  exit_tile_kernel<<<grid, THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(h),
                                               static_cast<const __nv_bfloat16*>(w),
                                               static_cast<float*>(part_m),
                                               static_cast<float*>(part_l),
                                               static_cast<int*>(part_i), B, d, V, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  exit_combine_kernel<<<B, 32, 0, s>>>(static_cast<const float*>(part_m),
                                       static_cast<const float*>(part_l),
                                       static_cast<const int*>(part_i),
                                       static_cast<float*>(conf), static_cast<int*>(idx), nt);
  return cudaGetLastError();
}
