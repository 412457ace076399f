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
                       int Sq, int Sk, int H, int KV, int hd, int causal,
                       int q_offset, float scale) {
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
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, int causal, int q_offset,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<QT, KT>;
  const size_t smem = kSmemFloats * sizeof(float);
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), Sq, Sk, H, KV, hd,
      causal, q_offset, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tc: bf16 q, k, v on tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 64, kTcBKV = 64, kTcThreads = 128;

template <int HD>
constexpr size_t tc_smem_bytes() {  // Q, then K and V double buffered
  return (size_t)(kTcBQ + 4 * kTcBKV) * (HD + 8) * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                int KV, int causal, int q_offset, float scale) {
  constexpr int LD = HD + 8;            // bf16 row stride in shared memory
  constexpr int NKS = HD / 16;          // k-steps of q.k
  constexpr int NHT = HD / 8;           // output n-tiles
  constexpr int NST = kTcBKV / 8;       // score n-tiles
  constexpr int CPR = HD / 8;           // 16-byte chunks a row
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

  for (int i = tid; i < kTcBQ * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < q_rows;
    mma::cp_async16(qs + r * LD + c,
                    ok ? q + (((size_t)b * Sq + q0 + r) * H + h) * HD + c : q,
                    ok ? 16 : 0);
  }
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * kTcBKV;
    for (int i = tid; i < kTcBKV * CPR; i += kTcThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < Sk;
      const size_t off = (size_t)(k0 + r) * kv_row + c;
      const size_t dst = ((size_t)buf * kTcBKV + r) * LD + c;
      mma::cp_async16(ks + dst, ok ? kb + off : kb, ok ? 16 : 0);
      mma::cp_async16(vs + dst, ok ? vb + off : vb, ok ? 16 : 0);
    }
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
  }
}

template <int HD>
int launch_tc_hd(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KV, int causal,
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
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal, q_offset,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, int hd, int causal,
              int q_offset, cudaStream_t s) {
  switch (hd) {
#define FLASH_TC_HD(n) \
  case n:              \
    return launch_tc_hd<n>(q, k, v, out, B, Sq, Sk, H, KV, causal, q_offset, s);
    FLASH_TC_HD(16) FLASH_TC_HD(32) FLASH_TC_HD(48) FLASH_TC_HD(64)
    FLASH_TC_HD(80) FLASH_TC_HD(96) FLASH_TC_HD(112) FLASH_TC_HD(128)
#undef FLASH_TC_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_is_bf16 / kv_is_bf16: 0 -> float32, 1 -> bfloat16 (out has q's type).
// variant: 0 fp32, 1 tc (the wrapper's names; tc needs bf16 q and k/v and
// hd % 16 == 0). All tensors contiguous in the layouts above. Returns
// cudaGetLastError() after the launch (or the error that refused it).
extern "C" int flash_attention_launch(const void* q, int q_is_bf16,
                                      const void* k, const void* v,
                                      int kv_is_bf16, void* out, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int causal, int q_offset, int variant,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
      hd > kHdMax || hd % 4 != 0 || q_offset < 0 ||
      (Sq + kBQ - 1) / kBQ > 65535 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (!q_is_bf16 || !kv_is_bf16 || hd % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_tc(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, q_offset, s);
  }
  if (q_is_bf16 && kv_is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, B, Sq, Sk, H,
                                                KV, hd, causal, q_offset, s);
  if (q_is_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                        causal, q_offset, s);
  if (kv_is_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                        causal, q_offset, s);
  return launch<float, float>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal,
                              q_offset, s);
}
