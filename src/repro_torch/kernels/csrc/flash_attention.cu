// Online-softmax (flash) attention over long sequences, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu
// (Pallas TPU kernel, body `_kernel`; oracle: the two-level scan of
// models/attention.py::flash_attention). Causal or not, with GQA:
//   q (B, Sq, H, hd), k/v (B, Sk, KV, hd), f32|bf16 -> out (B, Sq, H, hd)
//   in q's dtype, out[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h/G] * scale) v
// with scale = 1/sqrt(hd), G = H / KV, and under `causal` only the columns
// j <= q_offset + i (q_offset >= 0 puts q's rows at absolute positions in
// the kv range). Scores, probabilities and the accumulator are f32; the
// output is acc / max(l, 1e-30), as in the reference.
//
// What bounds it on the H100: operations. A head does 4 * hd FLOPs per
// unmasked (row, column) pair and reads each q, k, v row once; at
// S = 4096 that is ~1000 FLOP per byte, far above the ridge of either the
// FP32 CUDA cores (67 TFLOP/s, ~20 FLOP/byte) or the bf16 tensor cores
// (989 TFLOP/s, ~295 FLOP/byte). With bf16 q, k, v both products run
// exactly on bf16 tensor cores with f32 sums: q.k directly, and p.v with
// the f32 p split into three bf16 terms (p = p1 + p2 + p3 exactly), so
// the bound is (FLOPs/2 + 3 * FLOPs/2) / 989 TFLOP/s = 2 * FLOPs / 989 T.
// With an f32 operand every FLOP is bound at the FP32 rate.
//
// Two variants; the wrapper (kernels/flash_attention.py) picks one from the
// dtypes and the head dim, never from a failure:
//
// tc (q, k, v all bf16, hd a multiple of 16 up to 128, 16-byte aligned):
//   FlashAttention-2 on mma.sync m16n8k16. One CTA of 4 warps per
//   (batch x head, 64 query rows), each warp 16 rows whose Q fragments
//   stay in registers for the whole kv walk. K and V tiles of 64 rows sit
//   in shared memory as bf16 (row stride hd + 8: ldmatrix without bank
//   conflicts), double buffered with cp.async; V is read with
//   ldmatrix.trans. S = Q.K^T accumulates in f32 fragments; the online
//   softmax runs in registers, row max and sum reduced across each quad
//   with shuffles. The accumulator layout of S is the A layout of the next
//   product, so P never leaves registers: each tile's p1.V + p2.V + p3.V
//   is summed on the tensor cores, then added to O in f32 (their
//   accumulator truncates, which would lose p3 against a long running O).
// fp32 (everything else: f32 q or cache, mixed dtypes, other head dims;
//   PR 13's kernel): one CTA of 128 threads per (batch x head, 64-row
//   query block); the CTA keeps its query block transposed in shared
//   memory as f32 and walks the kv range in 64-row tiles (K transposed, V
//   as is, both converted to f32 on load). Each thread owns 8 query rows:
//   for the scores it computes an 8 x 4 register tile (float4
//   shared-memory reads, 32 FMAs per 3 loads), for the output an 8 x 8
//   tile of the accumulator (hd <= 128). The 16 threads of a row group sit
//   in one half-warp, so the row max and sum of the online softmax are
//   shuffles. P goes through shared memory (reusing K's buffer) to the P.V
//   product. Shared memory ~100 KB, so two CTAs share an SM.
//
// Either variant also writes, when given a pointer, each row's log-sum-exp
// lse = m + log(max(l, 1e-30)) as f32 (B, H, Sq), for the backward; without
// one the launch and its output bits are unchanged.
//
// Backward (flash_attention_bwd_launch; no TPU kernel: the reference's
// Pallas kernel has no VJP and the reference differentiates its XLA scan,
// models/attention.py::flash_attention, so this is the card's counterpart
// of that autodiff): dq, dk, dv from q, k, v, out, dout and lse, in three
// launches (D, a dk/dv pass, a dq pass), each output element summed by one
// thread in a fixed order: no atomics, the same bits on every call. Two
// variants, picked by the wrapper under the forward's rule (dout 16-byte
// aligned as well; out is read only by the D pre-pass, element by element):
// tc (see "backward, tc"): every product on bf16 tensor cores with f32
//   sums, P and dS split into two bf16 terms. Bound: operations, the five
//   products the function needs (S, dP, dV, dK, dQ; a product is 2 * hd
//   FLOPs an unmasked pair) at 989 TFLOP/s: 0.69 ms at the train shape
//   (B 2, S 4096, 32 heads of 128, causal). The design issues ten such
//   product-units: S, dP, 2 x dV, 2 x dK in the dk/dv pass and S, dP,
//   2 x dQ in the dq pass, so at the peak it would take twice the bound,
//   1.39 ms. The
//   second terms of P and dS keep the outputs within one bf16 rounding of
//   the exact gradients; the dq pass recomputes S and dP (25% more
//   tensor-core work than a fused dq) so that no CTA shares an output: a
//   per-CTA partial dq summed by a second pass would write and read back
//   ~4.3 GB at that shape.
// fp32 (see "backward"): f32 scores and sums on the FP32 CUDA cores, for
//   f32 or mixed inputs and head dims not a multiple of 16. Bound:
//   operations, 2.5 times the forward's (five products against two) at the
//   FP32 peak; it computes seven (the scores in both passes).
//
// Both: query head h reads kv head h/G, so GQA needs no head expansion.
// Causal: kv tiles wholly above the diagonal (first column > q_offset +
// the block's last row) are never loaded; inside a tile the mask sets the
// score to -1e30, whose exp is exactly 0 once the running max is finite,
// which it is after tile 0 (column 0 is live for every row when
// q_offset >= 0). Rows past Sq and columns past Sk are zero-filled in
// shared memory and never written. Heavy (late) query blocks go first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 128;    // 8 row groups x 16 column lanes
constexpr int kRows = 8;         // query rows per thread
constexpr int kSCols = 4;        // score columns per thread (kBK / 16)
constexpr int kHdMax = 128;
constexpr int kOCols = 8;        // output columns per thread (kHdMax / 16)
constexpr int kStride = kBQ + 4; // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemFloats =
    (size_t)2 * kHdMax * kStride + (size_t)kBK * kHdMax;

static_assert(kBQ == kBK, "P^T reuses the K^T buffer");
static_assert(kRows * (kThreads / 16) == kBQ, "row groups cover the block");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                       const KT* __restrict__ v, QT* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int KV, int hd, int causal, int q_offset,
                       float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [kHdMax][kStride]: Q^T
  float* kt = qt + kHdMax * kStride;            // [kHdMax][kStride]: K^T,
                                                // then [kBK][kStride]: P^T
  float* vs = kt + kHdMax * kStride;            // [kBK][kHdMax]: V

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*8 .. ty*8+7
  const int tx = tid & 15;  // score columns tx*4 .. +3; output columns
                            // tx*4 .. +3 and 64 + tx*4 .. +3
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);  // the query head's kv head
  // heavy (late) query blocks first: causal work grows with the block index
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_rows = min(kBQ, Sq - q0);

  // query block, transposed, f32; rows past Sq are zero
  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    float val = 0.f;
    if (r < q_rows)
      val = to_f32(q[(((size_t)b * Sq + q0 + r) * H + h) * hd + d]);
    qt[d * kStride + r] = val;
  }

  float o[kRows][kOCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) o[i][j] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q_offset + q0 + q_rows - 1;  // last row's position
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  const size_t kv_row = (size_t)KV * hd;  // elements between kv rows
  const KT* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * hd;
  const KT* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * hd;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, Sk - k0);
    __syncthreads();  // previous tile's P^T and V reads are done
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      float kv_k = 0.f, kv_v = 0.f;
      if (r < k_rows) {
        const size_t off = (size_t)(k0 + r) * kv_row + d;
        kv_k = to_f32(kb[off]);
        kv_v = to_f32(vb[off]);
      }
      kt[d * kStride + r] = kv_k;
      vs[r * kHdMax + d] = kv_v;
    }
    __syncthreads();

    // scores: rows ty*8+i, columns tx*4+j
    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &qt[d * kStride + ty * kRows]);
      const float4 qb = *reinterpret_cast<const float4*>(
          &qt[d * kStride + ty * kRows + 4]);
      const float4 kk = *reinterpret_cast<const float4*>(
          &kt[d * kStride + tx * kSCols]);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w,
                               qb.x, qb.y, qb.z, qb.w};
      const float kv[kSCols] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kSCols; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax per row (the 16 lanes of a row group
    // are one half-warp: xor shuffles below 16 stay inside it)
    float p[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row_pos = q_offset + q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const int col = k0 + tx * kSCols + j;
        float sv = s[i][j] * scale;
        if (col >= Sk || (causal && col > row_pos)) sv = kNegInf;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOCols; ++j) o[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading K^T
    float* pt = kt;   // [kBK][kStride]: P^T
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      float* dst = &pt[(tx * kSCols + j) * kStride + ty * kRows];
      *reinterpret_cast<float4*>(dst) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(p[4][j], p[5][j], p[6][j], p[7][j]);
    }
    __syncthreads();

    // o += P V over the tile's live rows (P is 0 on masked columns and V
    // is 0 past Sk, so the tail adds nothing)
#pragma unroll 4
    for (int c = 0; c < k_rows; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(
          &pt[c * kStride + ty * kRows]);
      const float4 pb = *reinterpret_cast<const float4*>(
          &pt[c * kStride + ty * kRows + 4]);
      const float4 va = *reinterpret_cast<const float4*>(
          &vs[c * kHdMax + tx * 4]);
      const float4 vb4 = *reinterpret_cast<const float4*>(
          &vs[c * kHdMax + 64 + tx * 4]);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
      const float vv[kOCols] = {va.x, va.y, va.z, va.w,
                                vb4.x, vb4.y, vb4.z, vb4.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOCols; ++j)
          o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= q_rows) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    QT* dst = out + (((size_t)b * Sq + q0 + r) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      const int col = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (col < hd) store(dst + col, o[i][j] * inv_l);
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
           int causal, int q_offset, cudaStream_t stream) {
  auto kern = flash_attention_kernel<QT, KT>;
  const size_t smem = kSmemFloats * sizeof(float);
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), lse, Sq, Sk, H, KV,
      hd, causal, q_offset, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tc: bf16 q, k, v on tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // rows of every tc tile in shared memory
constexpr int kTcBQ = kTcRows, kTcBKV = kTcRows, kTcThreads = 128;

// rows [0, n) of a (rows, HD) bf16 block with row stride `stride` elements
// into dst[64][HD + 8] by cp.async (not committed); rows n..63 zero-filled
template <int HD>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int n) {
  constexpr int CPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < kTcRows * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < n;
    mma::cp_async16(dst + r * LD + c, ok ? src + (size_t)r * stride + c : src,
                    ok ? 16 : 0);
  }
}

template <int HD>
constexpr size_t tc_smem_bytes() {  // Q, then K and V double buffered
  return (size_t)(kTcBQ + 4 * kTcBKV) * (HD + 8) * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Sk, int H, int KV, int causal, int q_offset,
                float scale) {
  constexpr int LD = HD + 8;            // bf16 row stride in shared memory
  constexpr int NKS = HD / 16;          // k-steps of q.k
  constexpr int NHT = HD / 8;           // output n-tiles
  constexpr int NST = kTcBKV / 8;       // score n-tiles
  extern __shared__ float4 tc_smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem4);
  __nv_bfloat16* ks = qs + kTcBQ * LD;        // [2][kTcBKV][LD]
  __nv_bfloat16* vs = ks + 2 * kTcBKV * LD;   // [2][kTcBKV][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int q_rows = min(kTcBQ, Sq - q0);
  const size_t kv_row = (size_t)KV * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * HD;

  tile_async<HD>(qs, q + (((size_t)b * Sq + q0) * H + h) * HD,
                 (size_t)H * HD, q_rows);
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * kTcBKV;
    const size_t off = (size_t)k0 * kv_row, dst = (size_t)buf * kTcBKV * LD;
    tile_async<HD>(ks + dst, kb + off, kv_row, Sk - k0);
    tile_async<HD>(vs + dst, vb + off, kv_row, Sk - k0);
    mma::cp_async_commit();
  };

  int n_tiles = (Sk + kTcBKV - 1) / kTcBKV;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + q_rows - 1) / kTcBKV + 1);
  load_kv(0, 0);  // Q's copies join the first group

  float o[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t qf[NKS][4];
  // absolute position of this thread's first row (the second is 8 below)
  const int row_a = q_offset + q0 + warp * 16 + g4;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, cur ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) in shared memory
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        mma::ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                 (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + (size_t)cur * kTcBKV * LD;
    const __nv_bfloat16* vt = vs + (size_t)cur * kTcBKV * LD;

    // S = Q K^T for the warp's 16 rows x 64 columns
    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t r[4];
        mma::ldsm_x4(r, kt + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }

    // scale, mask, online softmax (rows g4 and g4 + 8; a quad holds a row)
    const int k0 = t * kTcBKV;
    const bool need_mask =
        k0 + kTcBKV > Sk || (causal && k0 + kTcBKV - 1 > q_offset + q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[j][e] * scale;
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * q4 + (e & 1);
          if (col >= Sk || (causal && col > row_a + (e >> 1) * 8))
            sv = kNegInf;
        }
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_new[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
      m_r[r] = m_new[r];
    }
    // P as three exact bf16 terms a 16-column k-step, in the A layout
    uint32_t pa[kTcBKV / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < kTcBKV / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float a0, a1, a2, b0, b1, b2;
          mma::split3(s[2 * kk + half][rr * 2], a0, a1, a2);
          mma::split3(s[2 * kk + half][rr * 2 + 1], b0, b1, b2);
          const int slot = half * 2 + rr;  // a0 .. a3 of the A fragment
          pa[kk][0][slot] = mma::pack_bf16(a0, b0);
          pa[kk][1][slot] = mma::pack_bf16(a1, b1);
          pa[kk][2][slot] = mma::pack_bf16(a2, b2);
        }
    // O = alpha O + P V. The tensor cores' accumulator truncates, so the
    // tile's P V (64 terms) leaves it for O's f32 sum in round-to-nearest;
    // against a running O of up to Sk terms p3's products would be lost
#pragma unroll
    for (int hp = 0; hp < NHT / 2; ++hp) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTcBKV / 16; ++kk) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LD + (2 * hp + (lane >> 4)) * 8);
#pragma unroll
        for (int term = 2; term >= 0; --term) {
          mma::mma_bf16(pv[0], pa[kk][term], r[0], r[1]);
          mma::mma_bf16(pv[1], pa[kk][term], r[2], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[2 * hp + j][e] = fmaf(o[2 * hp + j][e], alpha[e >> 1], pv[j][e]);
    }
    __syncthreads();  // every warp is done with buffer cur before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g4 + r * 8;
    if (row >= q_rows) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * Sq + q0 + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NHT; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * q4) =
          mma::pack_bf16(o[j][2 * r] / den, o[j][2 * r + 1] / den);
    if (lse != nullptr && q4 == 0)
      lse[(size_t)bh * Sq + q0 + row] = m_r[r] + logf(den);
  }
}

template <int HD>
int launch_tc_hd(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                 int q_offset, cudaStream_t stream) {
  auto kern = flash_tc_kernel<HD>;
  const size_t smem = tc_smem_bytes<HD>();
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kTcBQ - 1) / kTcBQ);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, KV, causal,
      q_offset, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
              int causal, int q_offset, cudaStream_t s) {
  switch (hd) {
#define FLASH_TC_HD(n)                                                   \
  case n:                                                                \
    return launch_tc_hd<n>(q, k, v, out, lse, B, Sq, Sk, H, KV, causal, \
                           q_offset, s);
    FLASH_TC_HD(16) FLASH_TC_HD(32) FLASH_TC_HD(48) FLASH_TC_HD(64)
    FLASH_TC_HD(80) FLASH_TC_HD(96) FLASH_TC_HD(112) FLASH_TC_HD(128)
#undef FLASH_TC_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward, fp32 (FP32 CUDA cores, any dtype pair): three launches a call
// ---------------------------------------------------------------------------
//
// With P = exp(scale * Q K^T - lse) (masked entries 0) and
// D = rowsum(dO o O):  dV = P^T dO,  dS = P o (dO V^T - D),
// dK = scale * dS^T Q,  dQ = scale * dS K.
//   1. delta: D per (b, h, row) from the saved output, a warp a row.
//   2. dkdv:  one CTA per (b, kv head, 64 kv rows) keeps K^T and V^T in
//             shared memory and walks the G query heads of its kv head and
//             every query tile that can see its rows, in order, summing
//             dK and dV in registers (an 8 x 8 tile each a thread).
//   3. dq:    one CTA per (b, head, 64 query rows) keeps Q^T and dO^T and
//             walks the kv tiles its rows can see, summing dQ.
// Each output element is summed by one thread in a fixed order: no atomics,
// the same bits on every call. Tiles are the forward fp32 kernel's (64
// rows, 128 threads as 8 row groups x 16 column lanes); the products over
// the head dim read transposed f32 tiles ([d][row], row stride kStride),
// the products over tile rows a [row][d] copy and the P^T / dS^T buffer.

constexpr int kDeltaRows = 4;  // rows of the delta pass a CTA (a warp each)
constexpr size_t kTileT = (size_t)kHdMax * kStride;  // a transposed tile
constexpr size_t kTileR = (size_t)kBQ * kHdMax;      // a row-major tile
constexpr size_t kBufP = (size_t)kBQ * kStride;      // P^T / dS^T
// dkdv: K^T, V^T, Q^T, dO^T, Q, dO, P^T, lse, D;  dq: Q^T, dO^T, K^T, V^T,
// K, dS^T, lse, D
constexpr size_t kDkdvSmemFloats = 4 * kTileT + 2 * kTileR + kBufP + 2 * kBQ;
constexpr size_t kDqSmemFloats = 4 * kTileT + kTileR + kBufP + 2 * kBQ;

template <typename QT>
__global__ void __launch_bounds__(32 * kDeltaRows)
flash_bwd_delta_kernel(const QT* __restrict__ out,
                       const QT* __restrict__ dout, float* __restrict__ delta,
                       int rows, int Sq, int H, int hd) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kDeltaRows + (threadIdx.x >> 5);  // (b,i,h)
  if (r >= rows) return;
  const QT* o = out + (size_t)r * hd;
  const QT* d = dout + (size_t)r * hd;
  float acc = 0.f;
  for (int e = lane; e < hd; e += 32)
    acc = fmaf(to_f32(d[e]), to_f32(o[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = r % H, bi = r / H;
    delta[((size_t)(bi / Sq) * H + h) * Sq + bi % Sq] = acc;
  }
}

// the first n rows (row stride `stride` elements) of src into dst_t[d][r]
// as f32 (rows n..kBQ-1 zero) and, with dst_r, into dst_r[r][d] as well
template <typename T>
__device__ __forceinline__ void load_tile(float* dst_t, float* dst_r,
                                          const T* src, size_t stride, int n,
                                          int hd) {
  for (int e = threadIdx.x; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const float val = r < n ? to_f32(src[(size_t)r * stride + d]) : 0.f;
    dst_t[d * kStride + r] = val;
    if (dst_r != nullptr) dst_r[r * kHdMax + d] = val;
  }
}

// s[i][j] = sum_{d < hd} xt[d][ty*8 + i] * yt[d][tx*4 + j]
__device__ __forceinline__ void dot_tile(const float* xt, const float* yt,
                                         int hd, int ty, int tx,
                                         float (&s)[kRows][kSCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kSCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    const float4 xa = *reinterpret_cast<const float4*>(
        &xt[d * kStride + ty * kRows]);
    const float4 xb = *reinterpret_cast<const float4*>(
        &xt[d * kStride + ty * kRows + 4]);
    const float4 yy = *reinterpret_cast<const float4*>(
        &yt[d * kStride + tx * kSCols]);
    const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float yv[kSCols] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// o[i][j] += sum_{c < n} pt[c][ty*8 + i] * m[c][col j], col j = tx*4 + j
// (j < 4) or 64 + tx*4 + j - 4
__device__ __forceinline__ void acc_tile(const float* pt, const float* m,
                                         int n, int ty, int tx,
                                         float (&o)[kRows][kOCols]) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const float4 pa = *reinterpret_cast<const float4*>(
        &pt[c * kStride + ty * kRows]);
    const float4 pb = *reinterpret_cast<const float4*>(
        &pt[c * kStride + ty * kRows + 4]);
    const float4 ma = *reinterpret_cast<const float4*>(
        &m[c * kHdMax + tx * 4]);
    const float4 mb = *reinterpret_cast<const float4*>(
        &m[c * kHdMax + 64 + tx * 4]);
    const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    const float mv[kOCols] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOCols; ++j) o[i][j] = fmaf(pv[i], mv[j], o[i][j]);
  }
}

// s[i][j] (rows ty*8 + i, columns tx*4 + j) into buf[column][row]
__device__ __forceinline__ void store_t(float* buf, int ty, int tx,
                                        const float (&s)[kRows][kSCols]) {
#pragma unroll
  for (int j = 0; j < kSCols; ++j) {
    float* dst = &buf[(tx * kSCols + j) * kStride + ty * kRows];
    *reinterpret_cast<float4*>(dst) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
  }
}

// rows ty*8 + i < n of o (times `mul`) into dst + row * stride, columns < hd
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t stride, int n,
                                           int hd, int ty, int tx, float mul,
                                           const float (&o)[kRows][kOCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      const int col = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (col < hd) store(dst + (size_t)r * stride + col, o[i][j] * mul);
    }
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                      const KT* __restrict__ v, const QT* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, KT* __restrict__ dk,
                      KT* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      int hd, int causal, int q_offset, float scale) {
  extern __shared__ float4 bwd_smem4[];
  float* kt = reinterpret_cast<float*>(bwd_smem4);  // K^T
  float* vt = kt + kTileT;                           // V^T
  float* qt = vt + kTileT;                           // Q^T (query tile)
  float* ot = qt + kTileT;                           // dO^T
  float* qr = ot + kTileT;                           // Q [row][d]
  float* orow = qr + kTileR;                         // dO [row][d]
  float* pt = orow + kTileR;                         // P^T, then dS^T
  float* ls = pt + kBufP;                            // lse of the tile
  float* dl = ls + kBQ;                              // D of the tile

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  // causal: the first kv blocks see the most query tiles; they go first
  const int k0 = blockIdx.y * kBK;
  const int k_rows = min(kBK, Sk - k0);
  const size_t kv_off = ((size_t)b * Sk + k0) * KV * hd + (size_t)kh * hd;
  load_tile<KT>(kt, nullptr, k + kv_off, (size_t)KV * hd, k_rows, hd);
  load_tile<KT>(vt, nullptr, v + kv_off, (size_t)KV * hd, k_rows, hd);

  float dk_acc[kRows][kOCols], dv_acc[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query tiles wholly before k0 (every row's last visible column
  // < k0) contribute nothing
  const int t0 = causal ? max(0, k0 - q_offset) / kBQ : 0;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* d_h = delta + ((size_t)b * H + h) * Sq;
    for (int t = t0; t < n_qt; ++t) {
      const int q0 = t * kBQ;
      const int q_rows = min(kBQ, Sq - q0);
      const size_t q_off = (((size_t)b * Sq + q0) * H + h) * hd;
      __syncthreads();  // the previous tile's reads are done
      load_tile<QT>(qt, qr, q + q_off, (size_t)H * hd, q_rows, hd);
      load_tile<QT>(ot, orow, dout + q_off, (size_t)H * hd, q_rows, hd);
      if (tid < kBQ) {
        ls[tid] = tid < q_rows ? lse_h[q0 + tid] : 0.f;
        dl[tid] = tid < q_rows ? d_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // P^T: kv rows ty*8 + i, query columns tx*4 + j
      float s[kRows][kSCols];
      dot_tile(kt, qt, hd, ty, tx, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kSCols; ++j) {
          const int r = ty * kRows + i, c = tx * kSCols + j;
          const bool live = r < k_rows && c < q_rows &&
                            (!causal || k0 + r <= q_offset + q0 + c);
          s[i][j] = live ? expf(s[i][j] * scale - ls[c]) : 0.f;
        }
      store_t(pt, ty, tx, s);
      __syncthreads();
      acc_tile(pt, orow, q_rows, ty, tx, dv_acc);  // dV += P^T dO
      float dp[kRows][kSCols];
      dot_tile(vt, ot, hd, ty, tx, dp);            // (dO V^T)^T
      __syncthreads();  // every thread is done reading P^T
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const int c = tx * kSCols + j;
        float* col = &pt[c * kStride + ty * kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) col[i] = col[i] * (dp[i][j] - dl[c]);
      }
      __syncthreads();
      acc_tile(pt, qr, q_rows, ty, tx, dk_acc);    // dK += dS^T Q
    }
  }
  store_rows<KT>(dk + kv_off, (size_t)KV * hd, k_rows, hd, ty, tx, scale,
                 dk_acc);
  store_rows<KT>(dv + kv_off, (size_t)KV * hd, k_rows, hd, ty, tx, 1.f,
                 dv_acc);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const QT* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, QT* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int hd, int causal,
                    int q_offset, float scale) {
  extern __shared__ float4 bwd_smem4[];
  float* qt = reinterpret_cast<float*>(bwd_smem4);  // Q^T
  float* ot = qt + kTileT;                           // dO^T
  float* kt = ot + kTileT;                           // K^T (kv tile)
  float* vt = kt + kTileT;                           // V^T
  float* kr = vt + kTileT;                           // K [row][d]
  float* pt = kr + kTileR;                           // dS^T
  float* ls = pt + kBufP;
  float* dl = ls + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy blocks first
  const int q_rows = min(kBQ, Sq - q0);
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * hd;
  load_tile<QT>(qt, nullptr, q + q_off, (size_t)H * hd, q_rows, hd);
  load_tile<QT>(ot, nullptr, dout + q_off, (size_t)H * hd, q_rows, hd);
  if (tid < kBQ) {
    ls[tid] = tid < q_rows ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
    dl[tid] = tid < q_rows ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
  }

  float dq_acc[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOCols; ++j) dq_acc[i][j] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + q_rows - 1) / kBK + 1);
  const KT* kb = k + (size_t)b * Sk * KV * hd + (size_t)kh * hd;
  const KT* vb = v + (size_t)b * Sk * KV * hd + (size_t)kh * hd;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, Sk - k0);
    __syncthreads();  // the previous tile's reads are done
    load_tile<KT>(kt, kr, kb + (size_t)k0 * KV * hd, (size_t)KV * hd,
                  k_rows, hd);
    load_tile<KT>(vt, nullptr, vb + (size_t)k0 * KV * hd, (size_t)KV * hd,
                  k_rows, hd);
    __syncthreads();

    // query rows ty*8 + i, kv columns tx*4 + j
    float s[kRows][kSCols], dp[kRows][kSCols];
    dot_tile(qt, kt, hd, ty, tx, s);
    dot_tile(ot, vt, hd, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const int r = ty * kRows + i, c = tx * kSCols + j;
        const bool live = r < q_rows && c < k_rows &&
                          (!causal || k0 + c <= q_offset + q0 + r);
        const float p = live ? expf(s[i][j] * scale - ls[r]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl[r]);
      }
    store_t(pt, ty, tx, s);
    __syncthreads();
    acc_tile(pt, kr, k_rows, ty, tx, dq_acc);  // dQ += dS K
  }
  store_rows<QT>(dq + q_off, (size_t)H * hd, q_rows, hd, ty, tx, scale,
                 dq_acc);
}

template <typename QT>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         int B, int Sq, int H, int hd, cudaStream_t stream) {
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<QT><<<(rows + kDeltaRows - 1) / kDeltaRows,
                               32 * kDeltaRows, 0, stream>>>(
      static_cast<const QT*>(out), static_cast<const QT*>(dout), delta, rows,
      Sq, H, hd);
  return cudaGetLastError();
}

template <typename QT, typename KT>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int hd, int causal, int q_offset, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t e = launch_delta<QT>(out, dout, delta, B, Sq, H, hd, stream);
  if (e != cudaSuccess) return (int)e;

  auto dkdv = flash_bwd_dkdv_kernel<QT, KT>;
  const size_t smem_kv = kDkdvSmemFloats * sizeof(float);
  static int granted_kv[64];
  e = mma::allow_smem(dkdv, smem_kv, granted_kv);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(B * KV, (Sk + kBK - 1) / kBK), kThreads, smem_kv, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const QT*>(dout), lse, delta,
      static_cast<KT*>(dk), static_cast<KT*>(dv), Sq, Sk, H, KV, hd, causal,
      q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_kernel<QT, KT>;
  const size_t smem_q = kDqSmemFloats * sizeof(float);
  static int granted_q[64];
  e = mma::allow_smem(dqk, smem_q, granted_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(B * H, (Sq + kBQ - 1) / kBQ), kThreads, smem_q, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const QT*>(dout), lse, delta,
      static_cast<QT*>(dq), Sq, Sk, H, KV, hd, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward, tc: bf16 q, k, v, out and dout on tensor cores
// ---------------------------------------------------------------------------
//
// The same three launches and the same formulation as the fp32 backward,
// every product on mma.sync m16n8k16 (bf16 operands, f32 sums), 4 warps a
// CTA, 64-row tiles as bf16 in shared memory (row stride HD + 8: ldmatrix
// without bank conflicts), loaded with zero-filled cp.async16.
//   dkdv: a CTA per (b, kv head, 64 kv rows), each warp 16 kv rows. K and
//         V stay resident; the CTA walks its G query heads and every query
//         tile that can see its rows, in order, with the Q and dO tiles (and
//         their lse and D) double buffered. A tile costs S^T = K Q^T, then
//         P^T = exp(scale S^T - lse[col]) in f32 registers, dP^T = V dO^T,
//         dS^T = P^T o (dP^T - D[col]), dV += P^T dO and dK += dS^T Q: the
//         C layout of S^T and dP^T is the A layout of the last two, so P^T
//         and dS^T never leave registers.
//   dq:   a CTA per (b, head, 64 query rows), heavy blocks first, the
//         forward tc kernel's shape: Q and dO resident, K and V tiles
//         double buffered; a tile costs S = Q K^T, dP = dO V^T,
//         dS = P o (dP - D[row]) and dQ += dS K.
// P and dS enter their products as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi) (mma::split2): 16 significand bits, within 2^-17 |x|
// of x, against the outputs' own bf16 rounding (up to 2^-8). Each tile's
// products are summed in a fresh fragment and added to the running dK,
// dV, dQ in f32, as the forward adds P V: the tensor cores' accumulator
// truncates, and summed straight into the running fragments (512 steps
// over 4096 rows) its bias moves half as many bf16 outputs again off
// bf16(plain) as the same two-term arithmetic in f32 does (the card test
// test_flash_bwd_tensor_cores_keep_the_low_terms counts them).
// Scores, exponentials, lse, D and every sum are f32.
// Registers bound the tile shape at HD 128: dK and dV are 2 x 64 f32 a
// thread, S^T and dP^T 2 x 32, the split terms of P^T or dS^T 32 more, so
// every A fragment is read from shared memory at its use (8 ldmatrix.x4 a
// product for the warp's 16 rows) instead of held: K and V in the dk/dv
// pass, Q and dO in the dq pass.

template <int HD>
__host__ __device__ constexpr size_t tc_bwd_tile() {  // a 64-row tile, bf16s
  return (size_t)kTcRows * (HD + 8);
}

// acc[j] = A . B^T for the warp's 16 rows of A (a: its first row) against
// the 64 rows of B (n-tile j: B's rows 8j .. 8j+7), summed over HD; both
// row-major [row][HD + 8] in shared memory
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    mma::ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      mma::ldsm_x4(r, b + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(acc[2 * np], af, r[0], r[1]);
      mma::mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
    }
  }
}

// the warp's 16 x 64 f32 tile x in the C layout (x[j]: columns 8j .. 8j+7)
// as A fragments, two bf16 terms a 16-column k-step: xa[kk][0] the hi
// terms, xa[kk][1] the lo ones (slots a0 .. a3)
__device__ __forceinline__ void split_frags(const float (&x)[8][4],
                                            uint32_t (&xa)[4][2][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        mma::split2(x[2 * kk + half][rr * 2], x[2 * kk + half][rr * 2 + 1],
                    xa[kk][0][half * 2 + rr], xa[kk][1][half * 2 + rr]);
}

// acc[j] += X . M[:, 8j .. 8j+7] for X split by split_frags and M [64][HD
// + 8] row-major in shared memory, read transposed. Each pair of n-tiles
// sums the tile's 64 rows on the tensor cores in a fresh fragment (a
// k-step's lo product before its hi one), then adds it to acc in f32
template <int HD>
__device__ __forceinline__ void mma_xm(float (&acc)[HD / 8][4],
                                       const uint32_t (&xa)[4][2][4],
                                       const __nv_bfloat16* m, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int hp = 0; hp < HD / 16; ++hp) {
    float part[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      mma::ldsm_x4_t(r, m + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                LD + (2 * hp + (lane >> 4)) * 8);
#pragma unroll
      for (int term = 1; term >= 0; --term) {
        mma::mma_bf16(part[0], xa[kk][term], r[0], r[1]);
        mma::mma_bf16(part[1], xa[kk][term], r[2], r[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * hp + j][e] += part[j][e];
  }
}

// the warp's rows g4 and g4 + 8 of acc (times `mul`) as bf16 into
// dst + row * stride, rows below n only
template <int HD>
__device__ __forceinline__ void store_frag(__nv_bfloat16* dst, size_t stride,
                                           int row0, int n, float mul,
                                           const float (&acc)[HD / 8][4],
                                           int lane) {
  const int g4 = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g4 + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* p = dst + (size_t)row * stride + 2 * q4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + j * 8) =
          mma::pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                         int H, int KV, int causal, int q_offset,
                         float scale) {
  constexpr int LD = HD + 8, NHT = HD / 8;
  constexpr size_t T = tc_bwd_tile<HD>();
  extern __shared__ float4 bwd_tc_smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem4);
  __nv_bfloat16* vs = ks + T;
  __nv_bfloat16* qs = vs + T;      // [2] query tiles
  __nv_bfloat16* os = qs + 2 * T;  // [2] dO tiles
  float* ls = reinterpret_cast<float*>(os + 2 * T);  // [2][64] lse
  float* dls = ls + 2 * kTcRows;                   // [2][64] D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  // causal: the first kv blocks see the most query tiles; they go first
  const int k0 = blockIdx.y * kTcRows;
  const int k_rows = min(kTcRows, Sk - k0);
  const size_t kv_stride = (size_t)KV * HD, q_stride = (size_t)H * HD;
  const size_t kv_off = ((size_t)b * Sk + k0) * kv_stride + (size_t)kh * HD;
  tile_async<HD>(ks, k + kv_off, kv_stride, k_rows);
  tile_async<HD>(vs, v + kv_off, kv_stride, k_rows);
  mma::cp_async_commit();

  // causal: query tiles wholly before k0 contribute nothing
  const int t0 = causal ? max(0, k0 - q_offset) / kTcRows : 0;
  const int per_head = max(0, (Sq + kTcRows - 1) / kTcRows - t0);
  const int n_it = G * per_head;
  auto load_q = [&](int it, int buf) {
    const int h = kh * G + it / per_head;
    const int q0 = (t0 + it % per_head) * kTcRows;
    const int rows = min(kTcRows, Sq - q0);
    const size_t off = (((size_t)b * Sq + q0) * H + h) * HD;
    tile_async<HD>(qs + buf * T, q + off, q_stride, rows);
    tile_async<HD>(os + buf * T, dout + off, q_stride, rows);
    if (tid < kTcRows) {
      const bool ok = tid < rows;
      const size_t r = ((size_t)b * H + h) * Sq + q0 + (ok ? tid : 0);
      mma::cp_async4(ls + buf * kTcRows + tid, lse + r, ok ? 4 : 0);
      mma::cp_async4(dls + buf * kTcRows + tid, delta + r, ok ? 4 : 0);
    }
    mma::cp_async_commit();
  };
  if (n_it > 0) load_q(0, 0);

  float dka[NHT][4], dva[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int row_a = k0 + warp * 16 + g4;  // this thread's first kv row
  const __nv_bfloat16* kw = ks + warp * 16 * LD;
  const __nv_bfloat16* vw = vs + warp * 16 * LD;

  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, cur ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and K, V) in shared memory
    const __nv_bfloat16* qt = qs + cur * T;
    const __nv_bfloat16* ot = os + cur * T;
    const float* lt = ls + cur * kTcRows;
    const float* dt = dls + cur * kTcRows;
    const int q0 = (t0 + it % per_head) * kTcRows;
    const bool need_mask = k0 + kTcRows > Sk || q0 + kTcRows > Sq ||
                           (causal && k0 + kTcRows - 1 > q_offset + q0);

    float p[8][4];  // S^T, then P^T: kv rows x the tile's query columns
    mma_abt<HD>(p, kw, qt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + j * 8 + 2 * q4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = expf(p[j][e] * scale - ((e & 1) ? l2.y : l2.x));
        if (need_mask) {
          const int c = q0 + j * 8 + 2 * q4 + (e & 1);
          const int r = row_a + (e >> 1) * 8;
          if (r >= Sk || c >= Sq || (causal && r > q_offset + c)) x = 0.f;
        }
        p[j][e] = x;
      }
    }
    float ds[8][4];  // dP^T, then dS^T
    mma_abt<HD>(ds, vw, ot, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dt + j * 8 + 2 * q4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? d2.y : d2.x));
    }
    uint32_t xa[4][2][4];
    split_frags(p, xa);
    mma_xm<HD>(dva, xa, ot, lane);  // dV += P^T dO
    split_frags(ds, xa);
    mma_xm<HD>(dka, xa, qt, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with buffer cur before its refill
  }
  mma::cp_async_wait<0>();  // K and V's copies when no tile was walked

  store_frag<HD>(dk + kv_off, kv_stride, warp * 16, k_rows, scale, dka, lane);
  store_frag<HD>(dv + kv_off, kv_stride, warp * 16, k_rows, 1.f, dva, lane);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                       int KV, int causal, int q_offset, float scale) {
  constexpr int LD = HD + 8, NHT = HD / 8;
  constexpr size_t T = tc_bwd_tile<HD>();
  extern __shared__ float4 bwd_tc_smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem4);
  __nv_bfloat16* os = qs + T;      // dO
  __nv_bfloat16* ks = os + T;      // [2] K tiles
  __nv_bfloat16* vs = ks + 2 * T;  // [2] V tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heavy first
  const int q_rows = min(kTcRows, Sq - q0);
  const size_t kv_stride = (size_t)KV * HD, q_stride = (size_t)H * HD;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  tile_async<HD>(qs, q + q_off, q_stride, q_rows);
  tile_async<HD>(os, dout + q_off, q_stride, q_rows);
  auto load_kv = [&](int t, int buf) {
    const size_t off = (size_t)t * kTcRows * kv_stride;
    tile_async<HD>(ks + buf * T, kb + off, kv_stride, Sk - t * kTcRows);
    tile_async<HD>(vs + buf * T, vb + off, kv_stride, Sk - t * kTcRows);
    mma::cp_async_commit();
  };
  int n_tiles = (Sk + kTcRows - 1) / kTcRows;
  if (causal)
    n_tiles = min(n_tiles, (q_offset + q0 + q_rows - 1) / kTcRows + 1);
  load_kv(0, 0);  // Q's and dO's copies join the first group

  // lse and D of this thread's rows g4 and g4 + 8 (0 past Sq)
  float l_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g4 + r * 8;
    const bool ok = row < q_rows;
    l_r[r] = ok ? lse[(size_t)bh * Sq + q0 + row] : 0.f;
    d_r[r] = ok ? delta[(size_t)bh * Sq + q0 + row] : 0.f;
  }
  float dqa[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  const int row_a = q_offset + q0 + warp * 16 + g4;  // absolute position
  const __nv_bfloat16* qw = qs + warp * 16 * LD;
  const __nv_bfloat16* ow = os + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, cur ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, dO) in shared memory
    const __nv_bfloat16* kt = ks + cur * T;
    const __nv_bfloat16* vt = vs + cur * T;

    float p[8][4];  // S, then P
    mma_abt<HD>(p, qw, kt, lane);
    const int k0 = t * kTcRows;
    const bool need_mask = k0 + kTcRows > Sk ||
                           (causal && k0 + kTcRows - 1 > q_offset + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = expf(p[j][e] * scale - l_r[e >> 1]);
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * q4 + (e & 1);
          if (col >= Sk || (causal && col > row_a + (e >> 1) * 8)) x = 0.f;
        }
        p[j][e] = x;
      }
    float ds[8][4];  // dP, then dS
    mma_abt<HD>(ds, ow, vt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - d_r[e >> 1]);
    uint32_t xa[4][2][4];
    split_frags(ds, xa);
    mma_xm<HD>(dqa, xa, kt, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with buffer cur before its refill
  }

  store_frag<HD>(dq + q_off, q_stride, warp * 16, q_rows, scale, dqa, lane);
}

template <int HD>
int launch_bwd_tc_hd(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B,
                     int Sq, int Sk, int H, int KV, int causal, int q_offset,
                     cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t e =
      launch_delta<bf>(out, dout, delta, B, Sq, H, HD, stream);
  if (e != cudaSuccess) return (int)e;

  auto dkdv = flash_bwd_dkdv_tc_kernel<HD>;
  const size_t smem_kv = 6 * tc_bwd_tile<HD>() * sizeof(bf) +
                         4 * kTcRows * sizeof(float);
  static int granted_kv[64];
  e = mma::allow_smem(dkdv, smem_kv, granted_kv);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(B * KV, (Sk + kTcRows - 1) / kTcRows), kTcThreads,
         smem_kv, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H, KV, causal,
      q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_tc_kernel<HD>;
  const size_t smem_q = 6 * tc_bwd_tile<HD>() * sizeof(bf);
  static int granted_q[64];
  e = mma::allow_smem(dqk, smem_q, granted_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(B * H, (Sq + kTcRows - 1) / kTcRows), kTcThreads, smem_q,
        stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), Sq, Sk, H, KV, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                  int Sk, int H, int KV, int hd, int causal, int q_offset,
                  cudaStream_t s) {
  switch (hd) {
#define FLASH_BWD_TC_HD(n)                                                 \
  case n:                                                                  \
    return launch_bwd_tc_hd<n>(q, k, v, out, dout, lse, delta, dq, dk, dv, \
                               B, Sq, Sk, H, KV, causal, q_offset, s);
    FLASH_BWD_TC_HD(16) FLASH_BWD_TC_HD(32) FLASH_BWD_TC_HD(48)
    FLASH_BWD_TC_HD(64) FLASH_BWD_TC_HD(80) FLASH_BWD_TC_HD(96)
    FLASH_BWD_TC_HD(112) FLASH_BWD_TC_HD(128)
#undef FLASH_BWD_TC_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int hd, int q_offset) {
  return B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
         hd > kHdMax || hd % 4 != 0 || q_offset < 0 ||
         (Sq + kBQ - 1) / kBQ > 65535 || (Sk + kBK - 1) / kBK > 65535;
}

}  // namespace

// q_is_bf16 / kv_is_bf16: 0 -> float32, 1 -> bfloat16 (out has q's type).
// variant: 0 fp32, 1 tc (the wrapper's names; tc needs bf16 q and k/v and
// hd % 16 == 0). lse: null, or (B, H, Sq) f32 that receives each row's
// m + log(l) (the backward's input); out is the same bits either way. All
// tensors contiguous in the layouts above. Returns cudaGetLastError()
// after the launch (or the error that refused it).
extern "C" int flash_attention_launch(const void* q, int q_is_bf16,
                                      const void* k, const void* v,
                                      int kv_is_bf16, void* out, float* lse,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, int causal, int q_offset,
                                      int variant, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, hd, q_offset) || variant < 0 ||
      variant > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (!q_is_bf16 || !kv_is_bf16 || hd % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_tc(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, causal,
                     q_offset, s);
  }
  if (q_is_bf16 && kv_is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk,
                                                H, KV, hd, causal, q_offset,
                                                s);
  if (q_is_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                        hd, causal, q_offset, s);
  if (kv_is_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                        hd, causal, q_offset, s);
  return launch<float, float>(q, k, v, out, lse, B, Sq, Sk, H, KV, hd,
                              causal, q_offset, s);
}

// The backward: q, out, dout and dq in q's type; k, v, dk and dv in k's;
// lse (B, H, Sq) f32 from the forward; delta (B, H, Sq) f32 scratch.
// variant: 0 fp32, 1 tc (bf16 q and k/v, hd % 16 == 0; q, k, v and dout
// 16-byte aligned). Three launches (delta, dkdv, dq) on the stream;
// returns the first error.
extern "C" int flash_attention_bwd_launch(
    const void* q, int q_is_bf16, const void* k, const void* v,
    int kv_is_bf16, const void* out, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int KV, int hd, int causal, int q_offset, int variant, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, hd, q_offset) || lse == nullptr ||
      delta == nullptr || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (!q_is_bf16 || !kv_is_bf16 || hd % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_bwd_tc(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq,
                         Sk, H, KV, hd, causal, q_offset, s);
  }
  if (q_is_bf16 && kv_is_bf16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
        causal, q_offset, s);
  if (q_is_bf16)
    return launch_bwd<__nv_bfloat16, float>(q, k, v, out, dout, lse, delta,
                                            dq, dk, dv, B, Sq, Sk, H, KV, hd,
                                            causal, q_offset, s);
  if (kv_is_bf16)
    return launch_bwd<float, __nv_bfloat16>(q, k, v, out, dout, lse, delta,
                                            dq, dk, dv, B, Sq, Sk, H, KV, hd,
                                            causal, q_offset, s);
  return launch_bwd<float, float>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                  B, Sq, Sk, H, KV, hd, causal, q_offset, s);
}
