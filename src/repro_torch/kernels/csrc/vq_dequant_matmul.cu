// Fused VQ-decode + matmul for sm_90a: y = x @ dequant(words, codebooks).T.
//
// Replaces: src/repro/kernels/vq_dequant_matmul.py::vq_dequant_matmul
// (Pallas TPU kernel, body `_kernel`). Same layout contract
// (core/vq_linear.FusedVQLinear):
//   x          (M, K)  f32 or bf16 activations (read as f32)
//   words      N*K/d codes packed row-major into uint32 words: code s of
//              row n is lane f % lanes of word f / lanes, f = n*(K/d) + s
//              (lane l = bits [l*cbits, (l+1)*cbits)). Rows that fill whole
//              words give the (N, K/d*cbits/32) per-row layout; rows that
//              straddle words are one flat run, (1, N*K/d*cbits/32)
//   codebooks  (n_cg, n_bands, k_c, d) f32, int8 codebook * scale folded
//   scales     (N, K/Ns) f32 blockwise normalization plane, optional
//   y          (M, N) f32
// with N = n_bands * rows_per_band and K = n_cg * group_cols.
//
// What bounds it on the H100: the dense weight never reaches device
// memory; the packed words (2 bits/weight at 2.25bpv_2d) and the folded
// codebooks are all it reads besides x. For decode-shaped M (<= 4) that
// read bounds it (a few MB per layer, ~1-3 us at 3.35 TB/s). For the
// eval's M = 512 the 2*M*N*K FP32 operations bound it (the kernel does
// its products on the CUDA cores in FP32: ~0.26 ms at 67 TFLOP/s for a
// 4096 x 4096 layer).
//
// Design (simple and correct first; mma.sync / wgmma / TMA are later work):
// a grid of (N tiles) x (M tiles). Each CTA walks the K axis one column
// group at a time. At each group it stages the (bands of the tile, k_c, d)
// slice of that group's codebooks in shared memory; then, in chunks of BK
// columns, it reads the tile's packed words as uint32 (consecutive
// threads take consecutive spans of a row, so a warp reads a contiguous
// run of words; the flat code index needs no per-row word alignment),
// decodes the W tile into shared memory with a plain shared-memory
// gather (the TPU kernel's one-hot matmul was an MXU choice),
// multiplies in the scale plane when scale_block > 0, and accumulates
// x . W^T in FP32 registers (TM x TN outputs per thread). Ragged N, M and
// group tails are masked with zeros; no tile snapping is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    vq_dequant_matmul_kernel(const XT* __restrict__ x,
                             const uint32_t* __restrict__ words,
                             const float* __restrict__ cb,
                             const float* __restrict__ scales,
                             float* __restrict__ y, int M, int N, int K,
                             int d, int k_c, int cbits, int rows_per_band,
                             int group_cols, int scale_block, int n_bands) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  extern __shared__ float cb_s[];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_last = min(N, n0 + BN) - 1;
  const int band_lo = n0 / rows_per_band;
  const int nb_t = n_last / rows_per_band - band_lo + 1;
  const int lanes = 32 / cbits;
  const uint32_t cmask = cbits >= 32 ? 0xFFFFFFFFu : ((1u << cbits) - 1u);
  const int n_cg = K / group_cols;
  const int spk = BK / d;  // spans in a full chunk (BK % d == 0)
  const int nspans = K / d;  // codes per row
  const int n_sblk = scale_block > 0 ? K / scale_block : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < n_cg; ++g) {
    __syncthreads();  // every thread is done with the previous codebooks
    const float* cbg = cb + ((long long)g * n_bands + band_lo) * k_c * d;
    for (int i = tid; i < nb_t * k_c * d; i += NT) cb_s[i] = cbg[i];
    const int gend = (g + 1) * group_cols;
    for (int k0 = g * group_cols; k0 < gend; k0 += BK) {
      const int kw = min(BK, gend - k0);  // a multiple of d
      __syncthreads();  // codebooks staged; previous chunk consumed
      for (int i = tid; i < BM * BK; i += NT) {
        const int kk = i % BK, mm = i / BK, m = m0 + mm;
        xs[kk][mm] = (m < M && kk < kw)
                         ? to_f32(x[(long long)m * K + k0 + kk])
                         : 0.f;
      }
      const int spans = kw / d;
      const int s0 = k0 / d;
      for (int i = tid; i < BN * spk; i += NT) {
        const int sp = i % spk, nn = i / spk, n = n0 + nn;
        if (sp >= spans || n >= N) {
          for (int p = 0; p < d; ++p) ws[sp * d + p][nn] = 0.f;
          continue;
        }
        const long long f = (long long)n * nspans + s0 + sp;
        const uint32_t w = words[f / lanes];
        const int code = (int)((w >> ((int)(f % lanes) * cbits)) & cmask);
        const float* c =
            cb_s + ((n / rows_per_band - band_lo) * k_c + code) * d;
        for (int p = 0; p < d; ++p) {
          float v = c[p];
          if (scale_block > 0)
            v *= scales[(long long)n * n_sblk + (k0 + sp * d + p) / scale_block];
          ws[sp * d + p][nn] = v;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) y[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <typename XT, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const uint32_t* words, const float* cb,
           const float* scales, float* y, int M, int N, int K, int d,
           int k_c, int cbits, int rows_per_band, int group_cols,
           int scale_block, int n_bands, cudaStream_t stream) {
  auto kern = vq_dequant_matmul_kernel<XT, BM, BN, BK, TM, TN>;
  // codebook slice of the most bands an N tile can touch
  int nb_max = (BN + rows_per_band - 2) / rows_per_band + 1;
  if (nb_max > n_bands) nb_max = n_bands;
  const size_t smem = (size_t)nb_max * k_c * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  vq_dequant_matmul_kernel<XT, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), smem, stream>>>(
      static_cast<const XT*>(x), words, cb, scales, y, M, N, K, d, k_c,
      cbits, rows_per_band, group_cols, scale_block, n_bands);
  return (int)cudaGetLastError();
}

template <typename XT>
int dispatch(const void* x, const uint32_t* words, const float* cb,
             const float* scales, float* y, int M, int N, int K, int d,
             int k_c, int cbits, int rows_per_band, int group_cols,
             int scale_block, int n_bands, cudaStream_t stream) {
  if (M <= 16)  // decode-shaped: narrow M tile, more N tiles in flight
    return launch<XT, 16, 32, 32, 1, 2>(x, words, cb, scales, y, M, N, K, d,
                                        k_c, cbits, rows_per_band,
                                        group_cols, scale_block, n_bands,
                                        stream);
  return launch<XT, 64, 64, 32, 4, 4>(x, words, cb, scales, y, M, N, K, d,
                                      k_c, cbits, rows_per_band, group_cols,
                                      scale_block, n_bands, stream);
}

}  // namespace

// x_is_bf16: 0 -> x is float32, 1 -> x is bfloat16. scales may be null
// when scale_block == 0. Returns cudaGetLastError() after the launch.
extern "C" int vq_dequant_matmul_launch(
    const void* x, int x_is_bf16, const uint32_t* words, const float* cb,
    const float* scales, float* y, int M, int N, int K, int d, int k_c,
    int cbits, int rows_per_band, int group_cols, int scale_block,
    int n_bands, void* stream) {
  if (d < 1 || 32 % d != 0) return (int)cudaErrorInvalidValue;  // BK % d
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return dispatch<__nv_bfloat16>(x, words, cb, scales, y, M, N, K, d, k_c,
                                   cbits, rows_per_band, group_cols,
                                   scale_block, n_bands, s);
  return dispatch<float>(x, words, cb, scales, y, M, N, K, d, k_c, cbits,
                         rows_per_band, group_cols, scale_block, n_bands, s);
}
