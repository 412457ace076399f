// Fused VQ-decode + matmul for sm_90a: y = x @ dequant(words, codebooks).T.
//
// Replaces: src/repro/kernels/vq_dequant_matmul.py::vq_dequant_matmul
// (Pallas TPU kernel, body `_kernel`). Same layout contract
// (core/vq_linear.FusedVQLinear):
//   x          (M, K)  f32 or bf16 activations (row stride ldx)
//   words      N*K/d codes packed row-major into uint32 words: code s of
//              row n is lane f % lanes of word f / lanes, f = n*(K/d) + s
//              (lane l = bits [l*cbits, (l+1)*cbits)). Rows that fill whole
//              words give the (N, K/d*cbits/32) per-row layout; rows that
//              straddle words are one flat run, (1, N*K/d*cbits/32)
//   codebooks  (n_cg, n_bands, k_c, d) f32, int8 codebook * scale folded;
//              optionally also the int8 codebooks themselves and their f32
//              cb_scale (n_cg, n_bands), of which the f32 ones are the
//              product
//   scales     (N, K/Ns) f32 blockwise normalization plane, optional
//   y          (M, N) f32
// with N = n_bands * rows_per_band and K = n_cg * group_cols.
//
// What bounds it on the H100: at decode M the bytes of the packed words
// and codebooks (the dense weight never reaches device memory); from a few
// dozen rows of x up, the 2MNK operations, at the bf16 tensor-core peak
// for bf16 x and at the FP32 peak for f32 x. Each variant below gives its
// bound.
//
// Four variants; the wrapper (kernels/vq_dequant_matmul.py) picks one from
// M, x's dtype and the layout, never from a failure:
//
// splitk (M <= 16, any x dtype; the serve engine's decode ticks at M =
//   max_batch). Bound: the bytes of the packed words, the int8 codebooks
//   with their scales and x, 1.4-3.9 us for the Llama-2-7B projections. A
//   grid of (64-row N tiles) x (K splits of whole column groups, up to 1024
//   columns). Each CTA stages its split's x columns (M rows, zero-padded to
//   MT) and its groups' codebook slices (as f32: the int8 value times its
//   scale, exactly the folded f32 value) in shared memory. For the paper's
//   (d, code width) pairs on an aligned layout a thread takes 4 rows (one
//   read of x serves all four: the loop is bound by shared-memory traffic)
//   and streams their words as 16-byte loads (one uint4 holds 32 four-bit
//   codes), decoding in registers; a generic path takes any other layout a
//   word at a time. The lanes of a row reduce with shuffles; partial sums
//   go to a (splits, M, N) f32 scratch and a second kernel sums the splits
//   in order: no atomics. The split plan and every sum's order depend on
//   N, K and the layout only, never on M or on other rows, so y[m] is the
//   same bit for bit whatever else the batch holds, and from run to run.
// tc_int8 (M > 16, bf16 x, d in {1, 2, 4}, int8 codebooks given whose
//   slice fits shared memory three times, k_c * d a multiple of 4,
//   group_cols and the plane's block multiples of 64). Bound: 2MNK
//   operations at the bf16 tensor-core peak (989 TFLOP/s). 128 x 64 output
//   tiles, 8 warps of 32 x 32, mma.sync m16n8k16 bf16 -> f32, 64-column
//   k-steps. A 4-stage cp.async pipeline brings each step's x tile, the
//   words each thread decodes and the int8 codebook slice of each column
//   group three steps ahead; while the tensor cores run one step, the
//   threads decode the next step's W tile into shared memory as bf16 (an
//   int8 value is exact in bf16). The tensor cores' accumulator truncates,
//   so each step's products leave it for an f32 sum in round-to-nearest,
//   multiplied on the way by the column's (group, band) scale (times
//   plane[n, k/Ns] with a plane).
// tc_split3 (M > 16, bf16 x, d in {1, 2, 4}, otherwise): the same tiles;
//   the folded f32 W value (times the plane) is split into three bf16
//   terms that sum to it exactly, three MMAs a k-step, the step's sum
//   added to an f32 sum: the products are exact. Codebook values are read
//   through the L1 cache.
// fp32 (M > 16, f32 x, or bf16 x with another d): PR 11's kernel, FP32
//   CUDA-core FMAs on 64 x 64 tiles, decode through a shared-memory
//   codebook slice. Bound: 2MNK at the FP32 peak (67 TFLOP/s).
//
// Expert stacks (a mixture-of-experts layer: E matrices of one layout, x
// (E, M, K), y (E, M, N)) run in one launch: every variant's grid has a
// third axis, blockIdx.z = expert, and a CTA first moves each operand's
// pointer by the expert's stride (at_expert); the CTA body is the 2-D
// one, so expert e's rows of y are bitwise a 2-D launch's on its slice.
// The TPU kernel is mapped over the stack one pallas_call an expert;
// here the 3 x 128 launches a Qwen3-MoE layer would take become 3. The
// split-K partial sums are (n_splits, E, M, N), so the reduce pass sums
// all experts' splits in one launch, in split order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* x;
  const uint32_t* words;
  const float* cb_f;      // folded f32 codebooks
  const int8_t* cb_i8;    // int8 codebooks or null
  const float* cb_scale;  // (n_cg, n_bands), with cb_i8
  const float* scales;    // (N, K/sblk) or null
  float* y;
  float* part;  // (n_splits, M, N) scratch of splitk
  int ldx, M, N, K, d, k_c, cbits, rpb, gc, sblk, n_bands;
  int gps, n_splits, seg_cols;  // splitk plan
  // expert stacks: each operand's stride from one expert to the next (x
  // in bytes, the others in elements; y's is M * N) and the stride from
  // one split's partial sums to the next (experts * M * N)
  long long es_x, es_words, es_cb, es_cb_scale, es_scales, part_split;
};

// The operands of expert blockIdx.z (absent ones stay null).
__device__ __forceinline__ Args at_expert(const Args& a0) {
  const long long e = blockIdx.z;
  Args a = a0;
  a.x = static_cast<const char*>(a0.x) + e * a0.es_x;
  a.words = a0.words + e * a0.es_words;
  a.cb_f = a0.cb_f + e * a0.es_cb;
  a.cb_i8 = a0.cb_i8 != nullptr ? a0.cb_i8 + e * a0.es_cb : nullptr;
  a.cb_scale =
      a0.cb_scale != nullptr ? a0.cb_scale + e * a0.es_cb_scale : nullptr;
  a.scales = a0.scales != nullptr ? a0.scales + e * a0.es_scales : nullptr;
  a.y = a0.y + e * (long long)a0.M * a0.N;
  a.part = a0.part != nullptr ? a0.part + e * (long long)a0.M * a0.N
                              : nullptr;
  return a;
}

// ---------------------------------------------------------------------------
// fp32: PR 11's kernel (M > 16 where the tensor-core tiles do not apply)
// ---------------------------------------------------------------------------

template <typename XT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    vqdm_fp32_kernel(const Args a0) {
  const Args a = at_expert(a0);
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const uint32_t* __restrict__ words = a.words;
  const float* __restrict__ cb = a.cb_f;
  const float* __restrict__ scales = a.scales;
  float* __restrict__ y = a.y;
  const int M = a.M, N = a.N, K = a.K, d = a.d, k_c = a.k_c;
  const int cbits = a.cbits, rows_per_band = a.rpb, group_cols = a.gc;
  const int scale_block = a.sblk, n_bands = a.n_bands;
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

template <typename XT>
int launch_fp32(const Args& a, int n_experts, cudaStream_t stream) {
  constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
  auto kern = vqdm_fp32_kernel<XT, BM, BN, BK, TM, TN>;
  // codebook slice of the most bands an N tile can touch
  int nb_max = (BN + a.rpb - 2) / a.rpb + 1;
  if (nb_max > a.n_bands) nb_max = a.n_bands;
  const size_t smem = (size_t)nb_max * a.k_c * a.d * sizeof(float);
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, n_experts);
  kern<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// splitk: M <= 16
// ---------------------------------------------------------------------------

constexpr int kSkBN = 64;        // rows of W a CTA covers
constexpr int kSkThreads = 256;
constexpr int kSkRows = 4;       // W rows a thread of the fast path takes
constexpr int kSkLanes = kSkThreads / (kSkBN / kSkRows);  // 16 a row quad

// x's staged columns: one pad column every 64, so that the chunks of a
// row quad's lanes (64 or 32 columns apart) start in different banks
__device__ __forceinline__ int xs_col(int kk) { return kk + (kk >> 6); }

// Stage a segment [ka, kb): x's columns as f32 (rows past M zero) into
// xs[col][MT], and the codebook slices of its column groups (the int8
// value times its scale: exactly the folded f32 value) into cbs. kStage
// loads a thread are in flight before their stores.
template <int MT>
__device__ __forceinline__ void stage_segment(const Args& a, int x_is_bf16,
                                              int ka, int kb, int band_lo,
                                              int cbd, int cbg, float* xs,
                                              float* cbs) {
  constexpr int kStage = 8;
  const int tid = threadIdx.x;
  const int sc = kb - ka;
  const int g_a = ka / a.gc;
  const int ng = (kb - 1) / a.gc - g_a + 1;
  for (int i0 = tid; i0 < MT * sc; i0 += kSkThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kSkThreads;
      const int m = i / sc, kk = i - m * sc;
      v[u] = 0.f;
      if (i < MT * sc && m < a.M) {
        const long long off = (long long)m * a.ldx + ka + kk;
        v[u] = x_is_bf16 ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(a.x)[off])
                         : static_cast<const float*>(a.x)[off];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kSkThreads;
      const int m = i / sc, kk = i - m * sc;
      if (i < MT * sc) xs[xs_col(kk) * MT + m] = v[u];
    }
  }
  for (int i0 = tid; i0 < ng * cbg; i0 += kSkThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kSkThreads;
      v[u] = 0.f;
      if (i < ng * cbg) {
        const int gl = i / cbg, r = i - gl * cbg;
        const long long g = g_a + gl;
        const long long src = (g * a.n_bands + band_lo) * cbd + r;
        v[u] = a.cb_i8 != nullptr
                   ? (float)a.cb_i8[src] *
                         a.cb_scale[g * a.n_bands + band_lo + r / cbd]
                   : a.cb_f[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kSkThreads;
      if (i < ng * cbg) cbs[i] = v[u];
    }
  }
}

// shared-memory layout of a split-K CTA: xs [seg_pad][MT], ys [kSkBN][MT],
// cbs [groups][nb_t][k_c][d]
template <int MT>
__device__ __forceinline__ void splitk_smem(const Args& a, float*& xs,
                                            float*& ys, float*& cbs) {
  extern __shared__ float4 sk_smem4[];
  float* sm = reinterpret_cast<float*>(sk_smem4);
  const int seg_pad = xs_col(a.seg_cols - 1) + 1;
  xs = sm;
  ys = xs + ((seg_pad * MT + 3) & ~3);
  cbs = ys + kSkBN * MT;
}

// the CTA's rows of y (or of its split's partial sums) from ys
template <int MT>
__device__ __forceinline__ void splitk_store(const Args& a, const float* ys,
                                             int n0, int rows) {
  float* dst =
      a.n_splits == 1 ? a.y : a.part + (long long)blockIdx.y * a.part_split;
  for (int i = threadIdx.x; i < a.M * rows; i += kSkThreads) {
    const int m = i / rows, rl = i - m * rows;
    dst[(long long)m * a.N + n0 + rl] = ys[rl * MT + m];
  }
}

// Fast path: an aligned layout with d == D and container bits CB. A
// thread takes kSkRows rows (a row quad) and the chunks c = lane, lane +
// kSkLanes, ... of each (a chunk: one 16-byte load, 4 * 32/CB codes); one
// read of x from shared memory serves the quad's four rows. A chunk is 32
// or 64 columns wide and starts on a multiple of its width, so it never
// crosses a pad column and every x offset inside it is a constant.
template <int MT, int D, int CB, bool PLANE>
__device__ __forceinline__ void chunk_fma4(float (*acc)[MT], const float* xs,
                                           const uint4* w4,
                                           const float* const* cbr, int kk0,
                                           const float* const* plane_row,
                                           int kcol0, int sblk) {
  constexpr int L = 32 / CB;
  const float* xb = xs + xs_col(kk0) * MT;
#pragma unroll
  for (int wi = 0; wi < 4; ++wi)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float c[kSkRows][D];
#pragma unroll
      for (int r = 0; r < kSkRows; ++r) {
        const uint32_t w = wi == 0 ? w4[r].x
                           : wi == 1 ? w4[r].y
                           : wi == 2 ? w4[r].z
                                     : w4[r].w;
        const int code = (int)((w >> (l * CB)) & ((1u << CB) - 1u));
        const float* cp = cbr[r] + code * D;
        if constexpr (D == 2) {
          const float2 q = *reinterpret_cast<const float2*>(cp);
          c[r][0] = q.x;
          c[r][1] = q.y;
        } else if constexpr (D == 4) {
          const float4 q = *reinterpret_cast<const float4*>(cp);
          c[r][0] = q.x;
          c[r][1] = q.y;
          c[r][2] = q.z;
          c[r][3] = q.w;
        } else {
          c[r][0] = cp[0];
        }
      }
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const int t = (wi * L + l) * D + p;  // column within the chunk
        const float* xk = xb + t * MT;
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xk + m);
          xv[m] = q.x;
          xv[m + 1] = q.y;
          xv[m + 2] = q.z;
          xv[m + 3] = q.w;
        }
#pragma unroll
        for (int r = 0; r < kSkRows; ++r) {
          float v = c[r][p];
          if (PLANE) v *= plane_row[r][(kcol0 + t) / sblk];
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(xv[m], v, acc[r][m]);
        }
      }
    }
}

template <int MT, int D, int CB>
__global__ void __launch_bounds__(kSkThreads, MT <= 4 ? 3 : 2)
    vqdm_splitk_fast_kernel(const Args a0, int x_is_bf16) {
  static_assert(MT % 4 == 0, "x rows are read 4 at a time");
  const Args a = at_expert(a0);
  float *xs, *ys, *cbs;
  splitk_smem<MT>(a, xs, ys, cbs);
  constexpr int kLanes = 32 / CB;    // codes a word
  constexpr int kCw = 4 * kLanes;    // codes a chunk
  const int tid = threadIdx.x;
  const int rq = tid / kSkLanes, lr = tid % kSkLanes;
  const int n0 = blockIdx.x * kSkBN;
  const int rows = min(kSkBN, a.N - n0);
  const int band_lo = n0 / a.rpb;
  const int nb_t = (n0 + rows - 1) / a.rpb - band_lo + 1;
  const int n_cg = a.K / a.gc;
  const int g_lo = blockIdx.y * a.gps;
  const int k_lo = g_lo * a.gc, k_hi = min(n_cg, g_lo + a.gps) * a.gc;
  const int nspans = a.K / D;
  const int n_sblk = a.sblk > 0 ? a.K / a.sblk : 0;
  const int cbd = a.k_c * D;
  const int cbg = nb_t * cbd;

  // this thread's rows (a quad), -1 past N
  int rl[kSkRows];
  const uint4* wrow[kSkRows];
  const float* plane_row[kSkRows];
#pragma unroll
  for (int r = 0; r < kSkRows; ++r) {
    const int l = rq * kSkRows + r;
    rl[r] = l < rows ? l : -1;
    const int n = n0 + (l < rows ? l : 0);
    wrow[r] = reinterpret_cast<const uint4*>(a.words +
                                             (long long)n * nspans / kLanes);
    plane_row[r] = a.sblk > 0 ? a.scales + (long long)n * n_sblk : nullptr;
  }
  for (int i = tid; i < kSkBN * MT; i += kSkThreads) ys[i] = 0.f;

  for (int ka = k_lo; ka < k_hi; ka += a.seg_cols) {
    const int kb = min(k_hi, ka + a.seg_cols);
    const int g_a = ka / a.gc;
    const int c_lo = ka / D / kCw;          // the segment's first chunk
    const int R = (kb - ka) / D / kCw;      // chunks a row
    // the first chunk of each row is in flight while the segment stages
    uint4 w4[kSkRows];
#pragma unroll
    for (int r = 0; r < kSkRows; ++r)
      w4[r] = rl[r] >= 0 && lr < R ? __ldg(wrow[r] + c_lo + lr)
                                   : make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // the previous segment's x and codebooks are consumed
    stage_segment<MT>(a, x_is_bf16, ka, kb, band_lo, cbd, cbg, xs, cbs);
    __syncthreads();

    float acc[kSkRows][MT];
#pragma unroll
    for (int r = 0; r < kSkRows; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
    for (int c = lr; c < R; c += kSkLanes) {
      if (c != lr) {
#pragma unroll
        for (int r = 0; r < kSkRows; ++r)
          w4[r] = rl[r] >= 0 ? __ldg(wrow[r] + c_lo + c)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
      const int kcol0 = (c_lo + c) * kCw * D;
      const int gl = kcol0 / a.gc - g_a;
      const float* cbr[kSkRows];
#pragma unroll
      for (int r = 0; r < kSkRows; ++r)
        cbr[r] = cbs + gl * cbg +
                 ((n0 + max(rl[r], 0)) / a.rpb - band_lo) * cbd;
      if (a.sblk > 0)
        chunk_fma4<MT, D, CB, true>(acc, xs, w4, cbr, kcol0 - ka, plane_row,
                                    kcol0, a.sblk);
      else
        chunk_fma4<MT, D, CB, false>(acc, xs, w4, cbr, kcol0 - ka, plane_row,
                                     kcol0, a.sblk);
    }
    // a quad's kSkLanes lanes are an aligned half-warp
#pragma unroll
    for (int off = kSkLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kSkRows; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
    if (lr == 0)
#pragma unroll
      for (int r = 0; r < kSkRows; ++r)
        if (rl[r] >= 0)
#pragma unroll
          for (int m = 0; m < MT; ++m) ys[rl[r] * MT + m] += acc[r][m];
  }
  __syncthreads();
  splitk_store<MT>(a, ys, n0, rows);
}

// one code's d values (codebook row `c`, times the plane), into the rows
template <int MT>
__device__ __forceinline__ void decode_fma(float* acc, const float* xs,
                                           const float* c, int kk, int d,
                                           const float* plane_row, int kcol,
                                           int sblk) {
  for (int p = 0; p < d; ++p) {
    float v = c[p];
    if (sblk > 0) v *= plane_row[(kcol + p) / sblk];
    const float* xk = xs + xs_col(kk + p) * MT;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = fmaf(xk[m], v, acc[m]);
  }
}

// Any layout: whole words, codes outside the segment skipped; a power of
// two of lanes (up to the warp) takes one row, strided over its words.
template <int MT>
__global__ void __launch_bounds__(kSkThreads, 2)
    vqdm_splitk_kernel(const Args a0, int x_is_bf16) {
  const Args a = at_expert(a0);
  float *xs, *ys, *cbs;
  splitk_smem<MT>(a, xs, ys, cbs);
  const int d = a.d;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSkBN;
  const int rows = min(kSkBN, a.N - n0);
  const int band_lo = n0 / a.rpb;
  const int nb_t = (n0 + rows - 1) / a.rpb - band_lo + 1;
  const int n_cg = a.K / a.gc;
  const int g_lo = blockIdx.y * a.gps;
  const int k_lo = g_lo * a.gc, k_hi = min(n_cg, g_lo + a.gps) * a.gc;
  const int lanes = 32 / a.cbits;
  const uint32_t cmask = (1u << a.cbits) - 1u;
  const int nspans = a.K / d;
  const int n_sblk = a.sblk > 0 ? a.K / a.sblk : 0;
  const int cbd = a.k_c * d;
  const int cbg = nb_t * cbd;

  for (int i = tid; i < kSkBN * MT; i += kSkThreads) ys[i] = 0.f;
  for (int ka = k_lo; ka < k_hi; ka += a.seg_cols) {
    const int kb = min(k_hi, ka + a.seg_cols);
    const int g_a = ka / a.gc;
    __syncthreads();  // the previous segment's x and codebooks are consumed
    stage_segment<MT>(a, x_is_bf16, ka, kb, band_lo, cbd, cbg, xs, cbs);
    __syncthreads();
    const int sa = ka / d, sb = kb / d;
    const int R = (sb - sa + lanes - 1) / lanes + 1;  // words a row, at most
    int lpr = 1;
    while (lpr < R && lpr < 32) lpr <<= 1;
    const int rpp = kSkThreads / lpr;
    const int lr = tid & (lpr - 1);
    for (int r0 = 0; r0 < rows; r0 += rpp) {
      const int rl = r0 + tid / lpr;
      const bool live = rl < rows;
      float acc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.f;
      if (live) {
        const int n = n0 + rl;
        const long long rowf = (long long)n * nspans;
        const float* cbb = cbs + (n / a.rpb - band_lo) * cbd;
        const float* plane_row =
            a.sblk > 0 ? a.scales + (long long)n * n_sblk : nullptr;
        const long long fa = rowf + sa, fb = rowf + sb;
        const long long w_lo = fa / lanes, w_hi = (fb - 1) / lanes;
        for (long long wi = w_lo + lr; wi <= w_hi; wi += lpr) {
          uint32_t w = __ldg(a.words + wi);
          for (int l = 0; l < lanes; ++l, w >>= a.cbits) {
            const long long f = wi * lanes + l;
            if (f < fa || f >= fb) continue;
            const int kcol = (int)(f - rowf) * d;
            const float* cbr = cbb + (kcol / a.gc - g_a) * cbg;
            decode_fma<MT>(acc, xs, cbr + (int)(w & cmask) * d, kcol - ka,
                           d, plane_row, kcol, a.sblk);
          }
        }
      }
      // the row's lanes are an aligned power-of-two group of one warp
      for (int off = lpr >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (live && lr == 0)
#pragma unroll
        for (int m = 0; m < MT; ++m) ys[rl * MT + m] += acc[m];
    }
  }
  __syncthreads();
  splitk_store<MT>(a, ys, n0, rows);
}

// y = sum over splits of part, in split order (every expert's: part is
// (n_splits, experts, M, N), y (experts, M, N), mn = experts * M * N)
__global__ void vqdm_splitk_reduce(const float* __restrict__ part,
                                   float* __restrict__ y, long long mn,
                                   int n_splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int sp = 1; sp < n_splits; ++sp) s += part[sp * mn + i];
    y[i] = s;
  }
}

template <int MT, typename Kernel>
int launch_splitk_kernel(Kernel kern, int* granted, const Args& a,
                         int x_is_bf16, int n_experts, cudaStream_t stream) {
  int nb_max = (kSkBN + a.rpb - 2) / a.rpb + 1;
  if (nb_max > a.n_bands) nb_max = a.n_bands;
  const int seg_pad = (a.seg_cols - 1) + ((a.seg_cols - 1) >> 6) + 1;
  const int ng_max = a.seg_cols <= a.gc ? 1 : a.seg_cols / a.gc;
  const size_t smem = sizeof(float) *
                      ((size_t)((seg_pad * MT + 3) & ~3) + kSkBN * MT +
                       (size_t)ng_max * nb_max * a.k_c * a.d);
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + kSkBN - 1) / kSkBN, a.n_splits, n_experts);
  kern<<<grid, kSkThreads, smem, stream>>>(a, x_is_bf16);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return (int)e;
  const long long mn = a.part_split;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  vqdm_splitk_reduce<<<blocks, 256, 0, stream>>>(a.part, a.y, mn,
                                                 a.n_splits);
  return (int)cudaGetLastError();
}

// MT only sets how many staged rows of x (zeros past M) a thread FMAs
template <int D, int CB>
int launch_splitk_fast(const Args& a, int x_is_bf16, int n_experts,
                       cudaStream_t stream) {
  static int g4[64], g8[64], g16[64];
  if (a.M <= 4)
    return launch_splitk_kernel<4>(vqdm_splitk_fast_kernel<4, D, CB>, g4, a,
                                   x_is_bf16, n_experts, stream);
  if (a.M <= 8)
    return launch_splitk_kernel<8>(vqdm_splitk_fast_kernel<8, D, CB>, g8, a,
                                   x_is_bf16, n_experts, stream);
  return launch_splitk_kernel<16>(vqdm_splitk_fast_kernel<16, D, CB>, g16, a,
                                  x_is_bf16, n_experts, stream);
}

// vec == 4 only for the (d, container bits) pairs of the paper's presets
// (the wrapper's _SPLITK_FAST); anything else runs the generic kernel
int launch_splitk(const Args& a, int x_is_bf16, int vec, int n_experts,
                  cudaStream_t s) {
  if (vec == 4) {
    switch (a.d * 100 + a.cbits) {
      case 102: return launch_splitk_fast<1, 2>(a, x_is_bf16, n_experts, s);
      case 104: return launch_splitk_fast<1, 4>(a, x_is_bf16, n_experts, s);
      case 204: return launch_splitk_fast<2, 4>(a, x_is_bf16, n_experts, s);
      case 208: return launch_splitk_fast<2, 8>(a, x_is_bf16, n_experts, s);
      case 408: return launch_splitk_fast<4, 8>(a, x_is_bf16, n_experts, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  static int g4[64], g8[64], g16[64];
  if (a.M <= 4)
    return launch_splitk_kernel<4>(vqdm_splitk_kernel<4>, g4, a, x_is_bf16,
                                   n_experts, s);
  if (a.M <= 8)
    return launch_splitk_kernel<8>(vqdm_splitk_kernel<8>, g8, a, x_is_bf16,
                                   n_experts, s);
  return launch_splitk_kernel<16>(vqdm_splitk_kernel<16>, g16, a, x_is_bf16,
                                  n_experts, s);
}

// ---------------------------------------------------------------------------
// tensor cores: M > 16, bf16 x
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128, kTcBN = 64, kTcBK = 64;
constexpr int kTcThreads = 256;  // 8 warps: 4 (M) x 2 (N), 32 x 32 each
constexpr int kTcLd = kTcBK + 8;  // bf16 row stride: ldmatrix conflict-free
constexpr int kTcStages = 4;      // x, words and codebooks in flight
constexpr int kTcCols = kTcBK / 4;  // W columns a decoding thread takes
constexpr int kTcWords = 5;       // words those span at most
// int8 codebook slices in flight: group g's sits in buffer g % 3 from the
// issue of its first step (3 steps ahead) to the decode of its last, and
// three buffers keep that apart from group g + 3's issue for any group size
constexpr int kTcCbBufs = 3;

template <bool I8>
struct TcSmem {
  static constexpr int kTerms = I8 ? 1 : 3;
  static constexpr size_t kX = (size_t)kTcStages * kTcBM * kTcLd;  // bf16
  static constexpr size_t kW = (size_t)2 * kTerms * kTcBN * kTcLd;  // bf16
  static constexpr size_t kWords = (size_t)kTcStages * kTcThreads * kTcWords;
  // int8 codebook slices, each rounded to 16 bytes
  __host__ __device__ static size_t cb_stride(int cbg) {
    return ((size_t)cbg + 15) & ~(size_t)15;
  }
  static size_t bytes(int cbg) {
    return (kX + kW) * 2 + kWords * 4 +
           (I8 ? (size_t)kTcCbBufs * cb_stride(cbg) : 0);
  }
};

template <bool I8, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    vqdm_tc_kernel(const Args a0) {
  const Args a = at_expert(a0);
  using S = TcSmem<I8>;
  constexpr int BN = kTcBN, kThreads = kTcThreads;
  extern __shared__ float4 tc_smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tc_smem4);
  __nv_bfloat16* ws = xs + S::kX;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(ws + S::kW);
  int8_t* cbs = reinterpret_cast<int8_t*>(wsm + S::kWords);

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * BN;
  const int rows = min(BN, a.N - n0);
  const int band_lo = n0 / a.rpb;
  const int nb_t = (n0 + rows - 1) / a.rpb - band_lo + 1;
  const int cbd = a.k_c * D;
  const int cbg = nb_t * cbd;
  const size_t cb_st = S::cb_stride(cbg);
  const int nk = (a.K + kTcBK - 1) / kTcBK;
  const int lanes_log2 = 5 - (__ffs(a.cbits) - 1);  // cbits a power of 2
  const int lanes = 1 << lanes_log2;
  const uint32_t cmask = (1u << a.cbits) - 1u;
  const int nspans = a.K / D;
  const int n_sblk = a.sblk > 0 ? a.K / a.sblk : 0;
  const long long n_words = (long long)a.N * nspans >> lanes_log2;

  // decode: thread -> W row dr of the tile, kTcCols columns from dp
  const int dr = tid >> 2, dp = tid & 3;
  const bool drow = dr < rows;
  const int dn = n0 + dr;
  const int dband = drow ? dn / a.rpb : band_lo;
  constexpr int dnc = kTcCols / D;  // codes a thread decodes a step
  const long long drow_f = (long long)dn * nspans + dp * dnc;

  // this thread's codes of step s: how many, and where in its words
  auto codes_of = [&](int s, long long& wb, int& off) {
    const int kc = s * kTcBK + dp * kTcCols;
    const int nval = drow ? max(0, min(dnc, (a.K - kc) / D)) : 0;
    const long long f0 = drow_f + (long long)s * (kTcBK / D);
    wb = f0 >> lanes_log2;
    off = (int)(f0 - (wb << lanes_log2));
    return nval;
  };
  // every copy of step s -> stage s % kTcStages: the x tile, this
  // thread's words, and (int8 form) the codebook slice of column group g
  // when s starts it -> buffer g % kTcCbBufs
  auto issue = [&](int s, int g_start) {
    if (s < nk) {
      const int st = s % kTcStages;
      const int k0 = s * kTcBK;
      for (int i = tid; i < kTcBM * (kTcBK / 8); i += kThreads) {
        const int r = i / (kTcBK / 8), c = (i % (kTcBK / 8)) * 8;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < a.M && k < a.ldx;
        mma::cp_async16(xs + ((size_t)st * kTcBM + r) * kTcLd + c,
                        ok ? xp + (long long)m * a.ldx + k : xp, ok ? 16 : 0);
      }
      long long wb;
      int off;
      const int nval = codes_of(s, wb, off);
      const int nw = nval > 0 ? ((off + nval - 1) >> lanes_log2) + 1 : 0;
      uint32_t* dst = wsm + ((size_t)st * kThreads + tid) * kTcWords;
      for (int j = 0; j < nw; ++j)
        if (wb + j < n_words) mma::cp_async4(dst + j, a.words + wb + j, 4);
      if (I8 && g_start >= 0) {
        const int8_t* src =
            a.cb_i8 + ((long long)g_start * a.n_bands + band_lo) * cbd;
        int8_t* cdst = cbs + (size_t)(g_start % kTcCbBufs) * cb_st;
        for (int i = tid * 4; i < cbg; i += kThreads * 4)
          mma::cp_async4(cdst + i, src + i, min(4, cbg - i));
      }
    }
    mma::cp_async_commit();  // one group a step, empty past the end
  };
  // decode this thread's columns of step s (column group g) into ws[buf]
  auto decode = [&](int s, int g, int buf) {
    const int st = s % kTcStages;
    const int kc = s * kTcBK + dp * kTcCols;
    long long wb;
    int off;
    const int nval = codes_of(s, wb, off);
    const uint32_t* w = wsm + ((size_t)st * kThreads + tid) * kTcWords;
    const int8_t* cbr =
        I8 ? cbs + (size_t)(g % kTcCbBufs) * cb_st + (dband - band_lo) * cbd
           : nullptr;
    float v[kTcCols];
#pragma unroll
    for (int j = 0; j < kTcCols; ++j) v[j] = 0.f;
#pragma unroll
    for (int j = 0; j < dnc; ++j) {
      if (j >= nval) break;
      const int idx = off + j;
      const uint32_t word = w[idx >> lanes_log2];
      const int code =
          (int)((word >> ((idx & (lanes - 1)) * a.cbits)) & cmask);
#pragma unroll
      for (int p = 0; p < D; ++p) {
        float val;
        if (I8) {
          val = (float)cbr[code * D + p];
        } else {
          const int kcol = kc + j * D + p;
          val = __ldg(a.cb_f +
                      (((long long)(kcol / a.gc) * a.n_bands + dband) *
                           a.k_c + code) * D + p);
          if (a.sblk > 0)
            val *= __ldg(a.scales + (long long)dn * n_sblk + kcol / a.sblk);
        }
        v[j * D + p] = val;
      }
    }
#pragma unroll
    for (int h = 0; h < kTcCols / 8; ++h) {
      __nv_bfloat16* row = ws + dp * kTcCols + h * 8;
      if (I8) {
        *reinterpret_cast<uint4*>(row + ((size_t)buf * BN + dr) * kTcLd) =
            make_uint4(mma::pack_bf16(v[h * 8], v[h * 8 + 1]),
                       mma::pack_bf16(v[h * 8 + 2], v[h * 8 + 3]),
                       mma::pack_bf16(v[h * 8 + 4], v[h * 8 + 5]),
                       mma::pack_bf16(v[h * 8 + 6], v[h * 8 + 7]));
      } else {
        float t[3][8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma::split3(v[h * 8 + j], t[0][j], t[1][j], t[2][j]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
          *reinterpret_cast<uint4*>(
              row + (((size_t)buf * 3 + term) * BN + dr) * kTcLd) =
              make_uint4(mma::pack_bf16(t[term][0], t[term][1]),
                         mma::pack_bf16(t[term][2], t[term][3]),
                         mma::pack_bf16(t[term][4], t[term][5]),
                         mma::pack_bf16(t[term][6], t[term][7]));
      }
    }
  };

  float acc[2][4][4];    // the tensor cores' sum over one step
  float tot[2][4][4];    // the f32 sum of the steps
  float scl[4][2] = {};  // I8: the scales of this thread's 8 columns
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  // running column-group counters (no division in the loop): of the next
  // step to issue, of the next step to decode, and of the step in flight
  int is_g = -1, is_next = 0;   // issue: group, column where the next starts
  int de_g = -1, de_next = 0;   // decode
  int mm_g = -1, mm_next = 0, pl_b = -1, pl_next = 0;  // MMA: group, plane
  auto issue_step = [&](int s) {
    int gs = -1;
    if (s < nk && s * kTcBK == is_next) {
      gs = ++is_g;
      is_next += a.gc;
    }
    issue(s, gs);
  };
  auto decode_step = [&](int s, int buf) {
    if (s * kTcBK == de_next) {
      ++de_g;
      de_next += a.gc;
    }
    decode(s, de_g, buf);
  };

  // prologue: steps 0 .. kTcStages-2 in flight, step 0 decoded
  for (int s = 0; s < kTcStages - 1; ++s) issue_step(s);
  mma::cp_async_wait<kTcStages - 2>();
  __syncthreads();  // step 0's codebook slice, copied by all, is visible
  decode_step(0, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, st = kt % kTcStages;
    mma::cp_async_wait<kTcStages - 3>();  // steps <= kt + 1 landed
    __syncthreads();  // ... for every thread; step kt - 1 is done
    issue_step(kt + kTcStages - 1);
    const int k0 = kt * kTcBK;
    if (I8) {
      // a new scale block (column group, or plane block) starts here
      bool fresh = false;
      if (k0 == mm_next) {
        ++mm_g;
        mm_next += a.gc;
        fresh = true;
      }
      if (a.sblk > 0 && k0 == pl_next) {
        ++pl_b;
        pl_next += a.sblk;
        fresh = true;
      }
      if (fresh) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + nt * 8 + 2 * q4 + e;
            float sc = 0.f;
            if (n < a.N) {
              sc = __ldg(a.cb_scale + (long long)mm_g * a.n_bands + n / a.rpb);
              if (a.sblk > 0)
                sc *= __ldg(a.scales + (long long)n * n_sblk + pl_b);
            }
            scl[nt][e] = sc;
          }
      }
    }
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldsm_x4(af[mt], xs + ((size_t)st * kTcBM + wm * 32 + mt * 16 +
                                   (lane & 15)) * kTcLd +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int term = S::kTerms - 1; term >= 0; --term) {
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          mma::ldsm_x4(r, ws + (((size_t)cur * S::kTerms + term) * BN +
                                wn * 32 + (2 * np + (lane >> 4)) * 8 +
                                (lane & 7)) * kTcLd +
                              ks * 16 + ((lane >> 3) & 1) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }
    // the tensor cores' accumulator truncates: each step's sums leave it
    // for an f32 sum in round-to-nearest (int8 form: times the scale)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[mt][nt][e] = I8 ? fmaf(acc[mt][nt][e], scl[nt][e & 1],
                                     tot[mt][nt][e])
                              : tot[mt][nt][e] + acc[mt][nt][e];
          acc[mt][nt][e] = 0.f;
        }
    if (kt + 1 < nk) decode_step(kt + 1, cur ^ 1);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mt * 16 + g4 + (e >> 1) * 8;
        const int n = n0 + wn * 32 + nt * 8 + 2 * q4 + (e & 1);
        if (m < a.M && n < a.N) a.y[(long long)m * a.N + n] = tot[mt][nt][e];
      }
}

template <bool I8, int D>
int launch_tc_d(const Args& a, int n_experts, cudaStream_t stream) {
  auto kern = vqdm_tc_kernel<I8, D>;
  int nb_max = (kTcBN + a.rpb - 2) / a.rpb + 1;
  if (nb_max > a.n_bands) nb_max = a.n_bands;
  const size_t smem = TcSmem<I8>::bytes(nb_max * a.k_c * a.d);
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + kTcBN - 1) / kTcBN, (a.M + kTcBM - 1) / kTcBM,
            n_experts);
  kern<<<grid, kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// one 64-row N tile for both forms: a 128-row tile ran slower at every M
// measured on the H100
template <bool I8>
int launch_tc(const Args& a, int n_experts, cudaStream_t stream) {
  switch (a.d) {
    case 1: return launch_tc_d<I8, 1>(a, n_experts, stream);
    case 2: return launch_tc_d<I8, 2>(a, n_experts, stream);
    case 4: return launch_tc_d<I8, 4>(a, n_experts, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch's arguments, in this order, as one int64 array (pointers and
// the stream as addresses, 0 for null): one ctypes argument instead of 32
// keeps the host's cost of a call low (the decode ticks issue many).
//   x, x_is_bf16 (0: f32, 1: bf16), ldx (x's row stride, elements), words,
//   cb_f, cb_i8 / cb_scale (the int8 codebooks and their scales, or 0;
//   variant 2 needs them), scales (0 when scale_block == 0), y, part (the
//   (n_splits, experts, M, N) f32 scratch of variant 1 when n_splits > 1),
//   M, N, K, d, k_c, cbits, rows_per_band, group_cols, scale_block,
//   n_bands, variant (0 fp32, 1 splitk, 2 tc_int8, 3 tc_split3: the
//   wrapper's names), gps / n_splits / seg_cols / vec (variant 1's plan:
//   column groups a split, splits, columns a staged segment, words a
//   load), experts (1 for one matrix) and the per-expert strides of x (in
//   bytes), words, the codebooks (f32 and int8 alike), cb_scale and
//   scales (in elements), stream. M, N, K and the layout are one
//   expert's; every operand holds `experts` of them back to back.
// Returns cudaGetLastError() after the launch (or the error that refused
// it).
enum LaunchArg {
  kX, kXIsBf16, kLdx, kWords, kCbF, kCbI8, kCbScale, kScales, kY, kPart,
  kM, kN, kK, kD, kKc, kCbits, kRpb, kGc, kSblk, kNBands,
  kVariant, kGps, kNSplits, kSegCols, kVec,
  kExperts, kEsX, kEsWords, kEsCb, kEsCbScale, kEsScales, kStream
};

extern "C" int vq_dequant_matmul_launch(const long long* p) {
  auto ptr = [&](int i) { return reinterpret_cast<const void*>(p[i]); };
  const int M = (int)p[kM], N = (int)p[kN], K = (int)p[kK], d = (int)p[kD];
  const int cbits = (int)p[kCbits], ldx = (int)p[kLdx];
  const int x_is_bf16 = (int)p[kXIsBf16], vec = (int)p[kVec];
  const long long experts = p[kExperts];
  if (d < 1 || 32 % d != 0 || cbits < 1 || cbits > 16 || M < 1 || N < 1 ||
      experts < 1 || experts > 65535)
    return (int)cudaErrorInvalidValue;
  const int E = (int)experts;
  Args a{ptr(kX),
         static_cast<const uint32_t*>(ptr(kWords)),
         static_cast<const float*>(ptr(kCbF)),
         static_cast<const int8_t*>(ptr(kCbI8)),
         static_cast<const float*>(ptr(kCbScale)),
         static_cast<const float*>(ptr(kScales)),
         reinterpret_cast<float*>(p[kY]),
         reinterpret_cast<float*>(p[kPart]),
         ldx, M, N, K, d, (int)p[kKc], cbits, (int)p[kRpb], (int)p[kGc],
         (int)p[kSblk], (int)p[kNBands], (int)p[kGps], (int)p[kNSplits],
         (int)p[kSegCols], p[kEsX], p[kEsWords], p[kEsCb], p[kEsCbScale],
         p[kEsScales], experts * M * N};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p[kStream]);
  switch ((int)p[kVariant]) {
    case 0:
      if (ldx != K) return (int)cudaErrorInvalidValue;
      return x_is_bf16 ? launch_fp32<__nv_bfloat16>(a, E, s)
                       : launch_fp32<float>(a, E, s);
    case 1:
      if (M > 16 || a.gps < 1 || a.n_splits < 1 || a.seg_cols < d ||
          (vec != 1 && vec != 4) || (a.n_splits > 1 && a.part == nullptr))
        return (int)cudaErrorInvalidValue;
      return launch_splitk(a, x_is_bf16, vec, E, s);
    case 2:
      if (!x_is_bf16 || a.cb_i8 == nullptr || a.cb_scale == nullptr ||
          a.gc % kTcBK != 0 || (a.k_c * d) % 4 != 0 ||
          (a.sblk > 0 && a.sblk % kTcBK != 0) || ldx % 8 != 0)
        return (int)cudaErrorInvalidValue;
      return launch_tc<true>(a, E, s);
    case 3:
      if (!x_is_bf16 || ldx % 8 != 0) return (int)cudaErrorInvalidValue;
      return launch_tc<false>(a, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
