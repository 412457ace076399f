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
// An f32 operand is split the same way, so f32 work also runs exactly on
// the tensor cores: a product of two f32 operands costs six bf16 products
// (989/6 TFLOP/s), one with a bf16 side three (989/3).
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
// fp32 (everything else: f32 q or cache, mixed dtypes, other head dims,
//   any alignment; see "fp32" below): the same FlashAttention-2 walk with
//   every operand split into exact bf16 terms in shared memory and each
//   product issued as the bf16 products that reach f32's accuracy (six for
//   f32 x f32, three with a bf16 side), on the same mma.sync m16n8k16.
// Either variant also writes, when given a pointer, each row's log-sum-exp
// lse = m + log(max(l, 1e-30)) as f32 (B, H, Sq), for the backward; without
// one the launch and its output bits are unchanged.
//
// Backward (flash_attention_bwd_launch; no TPU kernel: the reference's
// Pallas kernel has no VJP and the reference differentiates its XLA scan,
// models/attention.py::flash_attention, so this is the card's counterpart
// of that autodiff): dq, dk, dv from q, k, v, out, dout and lse, in three
// launches (D, a dk/dv pass, a dq pass), each output element summed in a
// fixed order (by one thread; in fp32 by two, whose sums are added in a
// fixed order): no atomics, the same bits on every call. Two
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
// fp32 (see "fp32" below): the same three launches with every product on
//   the tensor cores through the exact split, for f32 or mixed inputs,
//   head dims not a multiple of 16 and any alignment. Bound: the five
//   products at 989/6 TFLOP/s (f32 x f32); the design issues seven (S and
//   dP again in the dq pass).
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

#include <algorithm>

#include "mma_sm90.cuh"

namespace {

constexpr int kHdMax = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
// backward, the D pre-pass (both variants)
// ---------------------------------------------------------------------------
//
// With P = exp(scale * Q K^T - lse) (masked entries 0) and
// D = rowsum(dO o O):  dV = P^T dO,  dS = P o (dO V^T - D),
// dK = scale * dS^T Q,  dQ = scale * dS K. D per (b, h, row) from the
// saved output, a warp a row, element by element (any alignment).

constexpr int kDeltaRows = 4;  // rows of the delta pass a CTA (a warp each)

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
// pass, Q and dO in the dq pass. From HD 80 up the dk/dv pass still
// spilled (148 bytes at 96, 180 at 112, 156 at 128), so there it walks a
// query tile in blocks of 16 or 32 columns (kQC): S^T, dP^T and the split
// terms take a quarter or a half of the registers, and each block's
// products are summed in their own fresh fragment before the f32 add.

template <int HD>
__host__ __device__ constexpr size_t tc_bwd_tile() {  // a 64-row tile, bf16s
  return (size_t)kTcRows * (HD + 8);
}

// acc[j] = A . B^T for the warp's 16 rows of A (a: its first row) against
// the NT * 8 rows of B (n-tile j: B's rows 8j .. 8j+7), summed over HD;
// both row-major [row][HD + 8] in shared memory
template <int HD, int NT = 8>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    mma::ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      mma::ldsm_x4(r, b + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(acc[2 * np], af, r[0], r[1]);
      mma::mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
    }
  }
}

// the warp's 16 x (NT * 8) f32 tile x in the C layout (x[j]: columns
// 8j .. 8j+7) as A fragments, two bf16 terms a 16-column k-step:
// xa[kk][0] the hi terms, xa[kk][1] the lo ones (slots a0 .. a3)
template <int NT = 8>
__device__ __forceinline__ void split_frags(const float (&x)[NT][4],
                                            uint32_t (&xa)[NT / 2][2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        mma::split2(x[2 * kk + half][rr * 2], x[2 * kk + half][rr * 2 + 1],
                    xa[kk][0][half * 2 + rr], xa[kk][1][half * 2 + rr]);
}

// acc[j] += X . M[:, 8j .. 8j+7] for X (16 x NT * 8) split by
// split_frags and M [NT * 8][HD + 8] row-major in shared memory, read
// transposed. Each pair of n-tiles sums M's NT * 8 rows on the tensor
// cores in a fresh fragment (a k-step's lo product before its hi one),
// then adds it to acc in f32
template <int HD, int NT = 8>
__device__ __forceinline__ void mma_xm(float (&acc)[HD / 8][4],
                                       const uint32_t (&xa)[NT / 2][2][4],
                                       const __nv_bfloat16* m, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int hp = 0; hp < HD / 16; ++hp) {
    float part[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
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
  // a tile's query columns in blocks of kQC: the dK and dV accumulators
  // (HD / 2 f32 a thread each) beside S^T and dP^T of all 64 columns (32
  // each) spill past the 255 registers from HD 80 up. Blocks of 16 leave
  // no spill at 80 and 96 (232 and 240 registers; blocks of 32 left 4 and
  // 8 bytes); at 112 and 128 blocks of 32 cut 180 / 156 bytes to 24 / 40
  // at the unblocked pass's speed, where blocks of 16 (4 / 8 bytes) cost
  // 3-6% (ptxas and the card, NVIDIA H100 80GB HBM3)
  constexpr int kQC = HD >= 112 ? 32 : HD >= 80 ? 16 : kTcRows;
  constexpr int NT = kQC / 8;
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

#pragma unroll 1
    for (int c0 = 0; c0 < kTcRows; c0 += kQC) {  // a block of query columns
      const __nv_bfloat16* qc = qt + c0 * LD;
      const __nv_bfloat16* oc = ot + c0 * LD;
      float p[NT][4];  // S^T, then P^T: kv rows x the block's query columns
      mma_abt<HD, NT>(p, kw, qc, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lt + c0 + j * 8 + 2 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = expf(p[j][e] * scale - ((e & 1) ? l2.y : l2.x));
          if (need_mask) {
            const int c = q0 + c0 + j * 8 + 2 * q4 + (e & 1);
            const int r = row_a + (e >> 1) * 8;
            if (r >= Sk || c >= Sq || (causal && r > q_offset + c)) x = 0.f;
          }
          p[j][e] = x;
        }
      }
      float ds[NT][4];  // dP^T, then dS^T
      mma_abt<HD, NT>(ds, vw, oc, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dt + c0 + j * 8 + 2 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t xa[NT / 2][2][4];
      split_frags<NT>(p, xa);
      mma_xm<HD, NT>(dva, xa, oc, lane);  // dV += P^T dO
      split_frags<NT>(ds, xa);
      mma_xm<HD, NT>(dka, xa, qc, lane);  // dK += dS^T Q
    }
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

// ---------------------------------------------------------------------------
// fp32: f32 or mixed inputs on bf16 tensor cores through an exact split
// ---------------------------------------------------------------------------
//
// An f32 value is exactly x1 + x2 + x3, three bf16 terms of 8 significand
// bits each (mma::split3; |x2| <= 2^-8 |x|, |x3| <= 2^-16 |x|); a bf16
// value is its own one term. A product of two split operands keeps the
// bf16 products x_i y_j with i + j <= 2 (0-based): six for f32 x f32,
// three when one side is bf16, one for bf16 x bf16. The three it drops
// (x2 y3, x3 y2, x3 y3) come to at most 2^-23 |x y|, about one f32
// rounding of the product, so a dot product keeps f32's accuracy. Each
// bf16 product is exact in the tensor cores' f32 sum, but that sum
// truncates: x1 y1 is summed in a fragment of its own and the smaller
// products in another (their sum is ~2^-8 of x1 y1's, so its truncation
// is too), and the two are added in f32 round-to-nearest; a tile's
// P V (and dV, dK, dQ) is summed in fresh fragments and added to the
// running sum in f32, as the tc kernels do.
//
// Why this route and not 3xTF32 (hi = tf32(x), lo = tf32(x - hi), three
// m16n8k8 TF32 products at half the bf16 rate: the same tensor-core time
// as six bf16 ones): it reuses the tc kernels' fragments, ldmatrix loads
// (there is no 32-bit ldmatrix.trans for V) and the accumulator-to-A
// register reuse of P and dS, whose m16n8k8 TF32 layouts differ; and a
// bf16 operand needs one term instead of two, so mixed dtypes issue half.
//
// Tiles live in shared memory as the operand's terms, bf16 planes
// [terms][rows][HDP + 8] (ldmatrix without bank conflicts), HDP the head
// dim rounded up to 64, 96, 112 or 128 with zero columns (any hd % 4 == 0
// up to 128). A CTA of 8 warps keeps one side resident (split once) and
// walks 32-row tiles of the other: each tile arrives raw in a staging
// buffer by cp.async (16, 8 or 4 bytes a copy, as the tensor's alignment
// allows; element by element for a bf16 tensor off 4 bytes) while the
// previous tile is computed, then the CTA splits it into the planes
// between two barriers. One CTA an SM (185 KB of shared memory at HDP
// 128, all f32), up to 255 registers a thread. A warp skips a tile that
// its rows cannot see under the causal mask. Products issue in
// product-major order over four n-tiles (S and P V; S beside dP in the
// backward), so that no accumulator waits on the one issued just before
// (issued n-tile by n-tile, the lo chains stalled the tensor cores: the
// SASS held NOPs between dependent HMMAs).
//   forward: a CTA per (batch x head, 128 query rows), heavy blocks first;
//     Q's planes resident, K and V in 32-row tiles; each warp 16 query
//     rows: S = Q K^T, the tc kernel's online softmax, P split into three
//     terms in registers (its C layout is the A layout), O += P V.
//   dk/dv: a CTA per (b, kv head, 64 kv rows) keeps K's and V's planes and
//     walks its G query heads and every 32-row query tile that sees its
//     rows (with their lse and D); warp w takes kv rows 16 (w / 2) and
//     query columns 16 (w % 2) of each tile: S^T = K Q^T, P^T, dV +=
//     P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//   dq: a CTA per (b, head, 64 query rows), heavy blocks first, keeps Q's
//     and dO's planes and walks 32-row kv tiles; warp w takes query rows
//     16 (w / 2) and kv columns 16 (w % 2): S, dP, dS, dQ += dS K.
// In both backward passes the two warps of a row block sum alternate
// column halves of every tile, each in a fixed order, and the even warp
// adds the odd one's sum to its own through shared memory at the end: no
// atomics, the same bits on every call.
// Bound: the same products as the tc pair at the bf16 peak divided by the
// products a split product issues (989/6 TFLOP/s for f32 x f32,
// 989/3 with a bf16 side; obs/work.py).

constexpr int kSpT = 32;         // rows of a walked tile
constexpr int kSpBQ = 128;       // query rows a forward CTA
constexpr int kSpRes = 64;       // resident rows a backward CTA
constexpr int kSpThreads = 256;  // 8 warps

// flags of a split launch: the dtypes, and the byte alignment (2, 4, 8 or
// 16) that every row of q, k, v and dout keeps, 2 bits each (code
// log2(align) - 1): the staged tiles' copy size, and whether a resident
// tile loads 4 elements at once (16 bytes of f32, 8 of bf16)
enum : int { kQBf16 = 1, kKvBf16 = 2 };
enum : int { kQAlign = 8, kKAlign = 10, kVAlign = 12, kOAlign = 14 };

__device__ __forceinline__ int align_of(int flags, int shift) {
  return 2 << ((flags >> shift) & 3);
}

__device__ __forceinline__ bool vec_of(int flags, int shift, bool bf16) {
  return align_of(flags, shift) >= (bf16 ? 8 : 16);
}

// v0, v1 as their three split3 terms, each a bf16x2 word (t[0] highest):
// one rounding a term for both values
__device__ __forceinline__ void split3x2(float v0, float v1, uint32_t (&t)[3]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v0, v1);
  const float2 f0 = __bfloat1622float2(h0);
  const float r0 = v0 - f0.x, r1 = v1 - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(r0, r1);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(r0 - f1.x, r1 - f1.y);
  t[0] = *reinterpret_cast<const uint32_t*>(&h0);
  t[1] = *reinterpret_cast<const uint32_t*>(&h1);
  t[2] = *reinterpret_cast<const uint32_t*>(&h2);
}

template <int N>  // N = 4, 8 or 16 bytes, `bytes` of them read, rest zero
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     mma::smem_addr(dst)), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     mma::smem_addr(dst)), "l"(src), "n"(N), "r"(bytes));
}

// rows [0, n) and columns [0, hd) of src (row stride `stride` elements)
// into the raw tile stg [ROWS][HDP] by cp.async of CB bytes a copy (not
// committed), the rest zero; CB 2: element by element
template <int HDP, int ROWS, int CB, typename T>
__device__ __forceinline__ void stage_cb(T* stg, const T* src, size_t stride,
                                         int n, int hd) {
  constexpr int E = sizeof(T);
  if constexpr (CB >= 4) {
    constexpr int CE = CB / E, CPR = HDP / CE;  // elements a copy, a row
    for (int i = threadIdx.x; i < ROWS * CPR; i += kSpThreads) {
      const int r = i / CPR, c = (i % CPR) * CE;
      const int valid = r < n ? max(0, min(CE, hd - c)) : 0;
      cp_async_n<CB>(stg + r * HDP + c,
                     valid ? src + (size_t)r * stride + c : src, valid * E);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HDP; i += kSpThreads) {
      const int r = i / HDP, c = i % HDP;
      stg[i] = r < n && c < hd ? src[(size_t)r * stride + c] : T();
    }
  }
}

template <int HDP, int ROWS, typename T>
__device__ __forceinline__ void stage_tile_t(T* stg, const T* src,
                                             size_t stride, int n, int hd,
                                             int align) {
  if (align == 16) stage_cb<HDP, ROWS, 16>(stg, src, stride, n, hd);
  else if (align == 8) stage_cb<HDP, ROWS, 8>(stg, src, stride, n, hd);
  else if (align == 4) stage_cb<HDP, ROWS, 4>(stg, src, stride, n, hd);
  else stage_cb<HDP, ROWS, 2>(stg, src, stride, n, hd);
}

template <int HDP, int ROWS>
__device__ __forceinline__ void stage_tile(void* stg, const void* src,
                                           bool bf16, size_t off,
                                           size_t stride, int n, int hd,
                                           int align) {
  if (bf16)
    stage_tile_t<HDP, ROWS>(static_cast<__nv_bfloat16*>(stg),
                            static_cast<const __nv_bfloat16*>(src) + off,
                            stride, n, hd, align);
  else
    stage_tile_t<HDP, ROWS>(static_cast<float*>(stg),
                            static_cast<const float*>(src) + off, stride, n,
                            hd, align);
}

// 4 consecutive elements (32-bit words w, f32: 4 words, bf16: 2) into
// the planes at d (plane stride `plane`): split3 for f32, a copy for bf16
template <bool F32>
__device__ __forceinline__ void put_terms(__nv_bfloat16* d, size_t plane,
                                          const uint32_t* w) {
  if (F32) {
    uint32_t lo[3], hi[3];
    split3x2(__uint_as_float(w[0]), __uint_as_float(w[1]), lo);
    split3x2(__uint_as_float(w[2]), __uint_as_float(w[3]), hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(d + p * plane) = make_uint2(lo[p], hi[p]);
  } else {
    *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
  }
}

// the staged raw tile [ROWS][HDP] of T as its planes [terms][ROWS][HDP + 8]
template <int HDP, int ROWS, typename T>
__device__ __forceinline__ void split_stage_t(__nv_bfloat16* dst,
                                              const T* stg) {
  constexpr int CPR = HDP / 4, N = ROWS * CPR, F32 = sizeof(T) == 4;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += kSpThreads) {
    const int i = i0 + threadIdx.x;
    if (N % kSpThreads != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * 4;
    uint32_t w[4];
    if (F32) {
      const uint4 u = *reinterpret_cast<const uint4*>(stg + r * HDP + c);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(stg + r * HDP + c);
      w[0] = u.x, w[1] = u.y;
    }
    put_terms<F32>(dst + r * (HDP + 8) + c, (size_t)ROWS * (HDP + 8), w);
  }
}

template <int HDP, int ROWS>
__device__ __forceinline__ void split_stage(__nv_bfloat16* dst,
                                            const void* stg, bool bf16) {
  if (bf16)
    split_stage_t<HDP, ROWS>(dst, static_cast<const __nv_bfloat16*>(stg));
  else
    split_stage_t<HDP, ROWS>(dst, static_cast<const float*>(stg));
}

// a resident tile, loaded once: rows [0, n) and columns [0, hd) of src
// straight into its planes through registers (4 elements a load when
// `vec`, else one at a time), the rest zero
template <int HDP, int ROWS, typename T>
__device__ __forceinline__ void split_tile_t(__nv_bfloat16* dst, const T* src,
                                             size_t stride, int n, int hd,
                                             bool vec) {
  constexpr int CPR = HDP / 4, N = ROWS * CPR;
  constexpr int PER = (N + kSpThreads - 1) / kSpThreads;
  constexpr bool F32 = sizeof(T) == 4;
  uint32_t w[PER][4];
#pragma unroll
  for (int k = 0; k < PER; ++k) {  // every load first, then every store
    const int i = threadIdx.x + k * kSpThreads;
    const int r = i / CPR, c = (i % CPR) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[k][j] = 0u;
    if (i < N && r < n && c < hd) {
      const T* p = src + (size_t)r * stride + c;
      if (F32 && vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        w[k][0] = u.x, w[k][1] = u.y, w[k][2] = u.z, w[k][3] = u.w;
      } else if (vec) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        w[k][0] = u.x, w[k][1] = u.y;
      } else if (F32) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[k][j] = reinterpret_cast<const uint32_t*>(p)[j];
      } else {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
        w[k][0] = (uint32_t)h[0] | ((uint32_t)h[1] << 16);
        w[k][1] = (uint32_t)h[2] | ((uint32_t)h[3] << 16);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * kSpThreads;
    if (i < N)
      put_terms<F32>(dst + (i / CPR) * (HDP + 8) + (i % CPR) * 4,
                     (size_t)ROWS * (HDP + 8), w[k]);
  }
}

template <int HDP, int ROWS>
__device__ __forceinline__ void split_tile(__nv_bfloat16* dst, const void* src,
                                           bool bf16, size_t off,
                                           size_t stride, int n, int hd,
                                           bool vec) {
  if (bf16)
    split_tile_t<HDP, ROWS>(dst, static_cast<const __nv_bfloat16*>(src) + off,
                            stride, n, hd, vec);
  else
    split_tile_t<HDP, ROWS>(dst, static_cast<const float*>(src) + off, stride,
                            n, hd, vec);
}

// the split product of A (G groups of terms a[g], na of them) and B (nb
// terms; b[j][m] one ldmatrix.x4: n-tiles 2m and 2m + 1) into NT n-tiles,
// n-tile n reading A group n * G / NT: hi[n] += a_0 b_0 and lo[n] += every
// other a_i b_j with i + j <= 2. Product-major: the products on one
// accumulator lie NT issues apart, past the tensor cores' latency
template <int NT, int G>
__device__ __forceinline__ void mma_split(float (&hi)[NT][4],
                                          float (&lo)[NT][4],
                                          const uint32_t (&a)[G][3][4], int na,
                                          const uint32_t (&b)[3][NT / 2][4],
                                          int nb) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    mma::mma_bf16(hi[n], a[n * G / NT][0], b[0][n >> 1][(n & 1) * 2],
                  b[0][n >> 1][(n & 1) * 2 + 1]);
#pragma unroll
  for (int p = 0; p < 5; ++p) {  // (i, j): (0,1) (1,0) (0,2) (1,1) (2,0)
    const int i = p < 2 ? p : p - 2, j = p < 2 ? 1 - p : 4 - p;
    if (i >= na || j >= nb) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma::mma_bf16(lo[n], a[n * G / NT][i], b[j][n >> 1][(n & 1) * 2],
                    b[j][n >> 1][(n & 1) * 2 + 1]);
  }
}

// the f32 C-layout values of a 16 x 16 block (x0: columns 0-7, x1: 8-15)
// as the three split3 terms of one A fragment
__device__ __forceinline__ void split_a(const float (&x0)[4],
                                        const float (&x1)[4],
                                        uint32_t (&a)[3][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* x = half ? x1 : x0;
      uint32_t t[3];
      split3x2(x[rr * 2], x[rr * 2 + 1], t);
#pragma unroll
      for (int i = 0; i < 3; ++i) a[i][half * 2 + rr] = t[i];
    }
}

// the planes of a 16-row A operand at row `row` (ldmatrix, one x4 a term)
template <int LD>
__device__ __forceinline__ void ld_a(uint32_t (&a)[3][4],
                                     const __nv_bfloat16* planes,
                                     size_t plane, int n, int row, int kk,
                                     int lane) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < n)
      mma::ldsm_x4(a[i], planes + i * plane + (row + (lane & 15)) * LD +
                             kk * 16 + (lane >> 4) * 8);
}

// B for two n-tiles, into b[j][m], from 16 rows (from `row`) of [n][k]
// planes: k-step kk
template <int LD, int M>
__device__ __forceinline__ void ld_b(uint32_t (&b)[3][M][4], int m,
                                     const __nv_bfloat16* planes,
                                     size_t plane, int n, int row, int kk,
                                     int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (j < n)
      mma::ldsm_x4(b[j][m], planes + j * plane +
                                (row + (lane >> 4) * 8 + (lane & 7)) * LD +
                                kk * 16 + ((lane >> 3) & 1) * 8);
}

// B for n-tiles 2hp, 2hp + 1 (columns 16 hp ..), into b[j][m], from 16 rows
// (from `row`, the k dimension) of [k][n] planes, read transposed
template <int LD, int M>
__device__ __forceinline__ void ld_bt(uint32_t (&b)[3][M][4], int m,
                                      const __nv_bfloat16* planes,
                                      size_t plane, int n, int row, int hp,
                                      int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (j < n)
      mma::ldsm_x4_t(b[j][m], planes + j * plane +
                                  (row + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                      LD + (2 * hp + (lane >> 4)) * 8);
}

// acc[2 hp ..] += X M over NT n-tiles from pair hp: X the warp's 16 rows
// of KS 16-column k-steps as split terms (xa[kk]), M [16 KS rows from
// `row`][HDP] planes read transposed, summed in fresh hi / lo fragments,
// then added in f32
template <int HDP, int NT, int KS>
__device__ __forceinline__ void acc_xm_n(float (&acc)[HDP / 8][4], int hp,
                                         const uint32_t (&xa)[KS][1][3][4],
                                         const __nv_bfloat16* m, size_t plane,
                                         int nm, int row, int lane) {
  float hi[NT][4] = {}, lo[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[3][NT / 2][4];
#pragma unroll
    for (int t = 0; t < NT / 2; ++t)
      ld_bt<HDP + 8>(b, t, m, plane, nm, row + kk * 16, hp + t, lane);
    mma_split<NT, 1>(hi, lo, xa[kk], 3, b, nm);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[2 * hp + j][e] += hi[j][e] + lo[j][e];
}

// acc += X M over every n-tile: four at a time, then the last two
template <int HDP, int KS>
__device__ __forceinline__ void acc_xm(float (&acc)[HDP / 8][4],
                                       const uint32_t (&xa)[KS][1][3][4],
                                       const __nv_bfloat16* m, size_t plane,
                                       int nm, int row, int lane) {
  constexpr int NP = HDP / 16;  // n-tile pairs
#pragma unroll
  for (int hp = 0; hp + 1 < NP; hp += 2)
    acc_xm_n<HDP, 4, KS>(acc, hp, xa, m, plane, nm, row, lane);
  if constexpr (NP % 2 != 0)
    acc_xm_n<HDP, 2, KS>(acc, NP - 1, xa, m, plane, nm, row, lane);
}

// two of the warp's 16 x 16 blocks over HDP, interleaved: s[0..1] = A0 .
// B0^T, s[2..3] = A1 . B1^T (A rows from ra of their planes, na terms; B
// rows from rb, nb terms), hi and lo added in f32
template <int HDP>
__device__ __forceinline__ void dot2_ab(float (&s)[4][4],
                                        const __nv_bfloat16* a0,
                                        const __nv_bfloat16* a1, size_t pa,
                                        int na, int ra,
                                        const __nv_bfloat16* b0,
                                        const __nv_bfloat16* b1, size_t pb,
                                        int nb, int rb, int lane) {
  constexpr int LD = HDP + 8;
  float hi[4][4] = {}, lo[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t af[2][3][4], bf[3][2][4];
    ld_a<LD>(af[0], a0, pa, na, ra, kk, lane);
    ld_a<LD>(af[1], a1, pa, na, ra, kk, lane);
    ld_b<LD>(bf, 0, b0, pb, nb, rb, kk, lane);
    ld_b<LD>(bf, 1, b1, pb, nb, rb, kk, lane);
    mma_split<4, 2>(hi, lo, af, na, bf, nb);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = hi[j][e] + lo[j][e];
}

// rows row0 + g4 and + 8 of acc (times `mul`) into dst + row * stride,
// rows below n and columns below hd, as T
template <int HDP, typename T>
__device__ __forceinline__ void store_acc_t(T* dst, size_t stride, int row0,
                                            int n, int hd, float mul,
                                            const float (&acc)[HDP / 8][4],
                                            int lane) {
  const int g4 = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g4 + r * 8;
    if (row >= n) continue;
    T* p = dst + (size_t)row * stride + 2 * q4;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      if (j * 8 + 2 * q4 >= hd) continue;  // hd is even: pairs stay whole
      const float a = acc[j][2 * r] * mul, b = acc[j][2 * r + 1] * mul;
      if (sizeof(T) == 4)
        *reinterpret_cast<float2*>(p + j * 8) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(p + j * 8) = mma::pack_bf16(a, b);
    }
  }
}

template <int HDP>
__device__ __forceinline__ void store_acc(void* dst, bool bf16, size_t off,
                                          size_t stride, int row0, int n,
                                          int hd, float mul,
                                          const float (&acc)[HDP / 8][4],
                                          int lane) {
  if (bf16)
    store_acc_t<HDP>(static_cast<__nv_bfloat16*>(dst) + off, stride, row0, n,
                     hd, mul, acc, lane);
  else
    store_acc_t<HDP>(static_cast<float*>(dst) + off, stride, row0, n, hd,
                     mul, acc, lane);
}

// the two warps of a row block (w, w ^ 1) sum alternate column halves:
// the odd one leaves its accumulator in slot (w / 2, a) of shared memory
// (pair_put), the even one adds it to its own (pair_add), between
// barriers once every tile read is done
template <int HDP>
__device__ __forceinline__ void pair_put(float* scratch, int slot,
                                         const float (&acc)[HDP / 8][4],
                                         int lane) {
  float* p = scratch + (size_t)slot * (HDP / 8) * 4 * 32;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[(j * 4 + e) * 32 + lane] = acc[j][e];
}

template <int HDP>
__device__ __forceinline__ void pair_add(const float* scratch, int slot,
                                         float (&acc)[HDP / 8][4], int lane) {
  const float* p = scratch + (size_t)slot * (HDP / 8) * 4 * 32;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += p[(j * 4 + e) * 32 + lane];
}

template <int HDP>
__global__ void __launch_bounds__(kSpThreads, 1)
flash_split_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, void* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                   int hd, int causal, int q_offset, float scale, int flags) {
  constexpr int LD = HDP + 8, NKS = HDP / 16, NHT = HDP / 8;
  constexpr int NST = kSpT / 8;  // score n-tiles a tile
  const bool q_bf = flags & kQBf16, kv_bf = flags & kKvBf16;
  const int nq = q_bf ? 1 : 3, nk = kv_bf ? 1 : 3;
  const size_t pq = (size_t)kSpBQ * LD, pk = (size_t)kSpT * LD;
  extern __shared__ float4 sp_smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sp_smem4);
  __nv_bfloat16* ks = qs + nq * pq;  // [nk][32][LD]
  __nv_bfloat16* vs = ks + nk * pk;  // [nk][32][LD]
  char* stg_k = reinterpret_cast<char*>(vs + nk * pk);  // [32][HDP] raw
  char* stg_v = stg_k + kSpT * HDP * (kv_bf ? 2 : 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kSpBQ;  // heavy blocks first
  const int q_rows = min(kSpBQ, Sq - q0);
  const size_t q_stride = (size_t)H * hd, kv_stride = (size_t)KV * hd;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * hd;
  const size_t kv_base = (size_t)b * Sk * kv_stride + (size_t)kh * hd;
  auto stage = [&](int t) {
    const size_t off = kv_base + (size_t)t * kSpT * kv_stride;
    stage_tile<HDP, kSpT>(stg_k, k, kv_bf, off, kv_stride, Sk - t * kSpT,
                          hd, align_of(flags, kKAlign));
    stage_tile<HDP, kSpT>(stg_v, v, kv_bf, off, kv_stride, Sk - t * kSpT,
                          hd, align_of(flags, kVAlign));
    mma::cp_async_commit();
  };
  stage(0);
  split_tile<HDP, kSpBQ>(qs, q, q_bf, q_off, q_stride, q_rows, hd,
                         vec_of(flags, kQAlign, q_bf));

  int n_tiles = (Sk + kSpT - 1) / kSpT;
  if (causal)
    n_tiles = min(n_tiles, (q_offset + q0 + q_rows - 1) / kSpT + 1);
  float o[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row_a = q_offset + q0 + warp * 16 + g4;  // absolute position

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kSpT;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp is done with tile t - 1
    split_stage<HDP, kSpT>(ks, stg_k, kv_bf);
    split_stage<HDP, kSpT>(vs, stg_v, kv_bf);
    __syncthreads();  // tile t (and Q) split; the staging buffer is free
    if (t + 1 < n_tiles) stage(t + 1);
    // causal: a tile past every row of this warp adds nothing
    if (causal && k0 > row_a - g4 + 15) continue;

    // S = Q K^T for the warp's 16 rows x 32 columns
    float sh[NST][4] = {}, sl[NST][4] = {};
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      uint32_t qa[1][3][4], kb[3][NST / 2][4];
      ld_a<LD>(qa[0], qs, pq, nq, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < NST / 2; ++np)
        ld_b<LD>(kb, np, ks, pk, nk, np * 16, kk, lane);
      mma_split<NST, 1>(sh, sl, qa, nq, kb, nk);
    }

    // scale, mask, online softmax (rows g4 and g4 + 8; a quad holds a row)
    const bool need_mask =
        k0 + kSpT > Sk || (causal && k0 + kSpT - 1 > q_offset + q0);
    float s[NST][4], mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = (sh[j][e] + sl[j][e]) * scale;
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
    uint32_t pa[NST / 2][1][3][4];
#pragma unroll
    for (int kk = 0; kk < NST / 2; ++kk)
      split_a(s[2 * kk], s[2 * kk + 1], pa[kk][0]);
    // O = alpha O + P V, the tile's P V summed in fresh fragments, four
    // n-tiles at a time
#pragma unroll
    for (int j = 0; j < NHT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    acc_xm<HDP, NST / 2>(o, pa, vs, pk, nk, 0, lane);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(l_r[r], 1e-30f);
    const int row = warp * 16 + g4 + r * 8;
    if (lse != nullptr && q4 == 0 && row < q_rows)
      lse[(size_t)bh * Sq + q0 + row] = m_r[r] + logf(den[r]);
  }
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= den[e >> 1];
  store_acc<HDP>(out, q_bf, q_off, q_stride, warp * 16, q_rows, hd, 1.f, o,
                 lane);
}

template <int HDP>
__global__ void __launch_bounds__(kSpThreads, 1)
flash_bwd_dkdv_split_kernel(const void* __restrict__ q,
                            const void* __restrict__ k,
                            const void* __restrict__ v,
                            const void* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            void* __restrict__ dk, void* __restrict__ dv,
                            int Sq, int Sk, int H, int KV, int hd, int causal,
                            int q_offset, float scale, int flags) {
  constexpr int LD = HDP + 8, NHT = HDP / 8;
  const bool q_bf = flags & kQBf16, kv_bf = flags & kKvBf16;
  const int nq = q_bf ? 1 : 3, nk = kv_bf ? 1 : 3;
  const size_t pr = (size_t)kSpRes * LD, pt = (size_t)kSpT * LD;
  extern __shared__ float4 sp_smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(sp_smem4);
  __nv_bfloat16* vs = ks + nk * pr;
  __nv_bfloat16* qs = vs + nk * pr;  // the query tile's planes
  __nv_bfloat16* os = qs + nq * pt;  // dO's
  float* ls = reinterpret_cast<float*>(os + nq * pt);  // [2][32] lse
  float* dls = ls + 2 * kSpT;                          // [2][32] D
  char* stg_q = reinterpret_cast<char*>(dls + 2 * kSpT);  // [32][HDP] raw
  char* stg_o = stg_q + kSpT * HDP * (q_bf ? 2 : 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int rw = (warp >> 1) * 16, cw = (warp & 1) * 16;  // kv rows, q cols
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  // causal: the first kv blocks see the most query tiles; they go first
  const int k0 = blockIdx.y * kSpRes;
  const int k_rows = min(kSpRes, Sk - k0);
  const size_t kv_stride = (size_t)KV * hd, q_stride = (size_t)H * hd;
  const size_t kv_off = ((size_t)b * Sk + k0) * kv_stride + (size_t)kh * hd;

  // causal: query tiles wholly before k0 contribute nothing
  const int t0 = causal ? max(0, k0 - q_offset) / kSpT : 0;
  const int per_head = max(0, (Sq + kSpT - 1) / kSpT - t0);
  const int n_it = G * per_head;
  auto stage = [&](int it) {
    const int h = kh * G + it / per_head;
    const int q0 = (t0 + it % per_head) * kSpT;
    const int rows = min(kSpT, Sq - q0);
    const size_t off = (((size_t)b * Sq + q0) * H + h) * hd;
    stage_tile<HDP, kSpT>(stg_q, q, q_bf, off, q_stride, rows, hd,
                          align_of(flags, kQAlign));
    stage_tile<HDP, kSpT>(stg_o, dout, q_bf, off, q_stride, rows, hd,
                          align_of(flags, kOAlign));
    if (tid < kSpT) {
      const bool ok = tid < rows;
      const size_t r = ((size_t)b * H + h) * Sq + q0 + (ok ? tid : 0);
      const int buf = (it & 1) * kSpT + tid;
      mma::cp_async4(ls + buf, lse + r, ok ? 4 : 0);
      mma::cp_async4(dls + buf, delta + r, ok ? 4 : 0);
    }
    mma::cp_async_commit();
  };
  if (n_it > 0) stage(0);
  split_tile<HDP, kSpRes>(ks, k, kv_bf, kv_off, kv_stride, k_rows, hd,
                          vec_of(flags, kKAlign, kv_bf));
  split_tile<HDP, kSpRes>(vs, v, kv_bf, kv_off, kv_stride, k_rows, hd,
                          vec_of(flags, kVAlign, kv_bf));

  float dka[NHT][4], dva[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int row_a = k0 + rw + g4;  // this thread's first kv row

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (t0 + it % per_head) * kSpT;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile it staged; every warp is done with it - 1
    split_stage<HDP, kSpT>(qs, stg_q, q_bf);
    split_stage<HDP, kSpT>(os, stg_o, q_bf);
    __syncthreads();  // tile it split (and K, V); the staging is free
    if (it + 1 < n_it) stage(it + 1);
    // causal: every column of the warp's half before its first kv row
    if (causal && k0 + rw > q_offset + q0 + cw + 15) continue;
    const float* lt = ls + (it & 1) * kSpT;
    const float* dt = dls + (it & 1) * kSpT;
    const bool need_mask = k0 + kSpRes > Sk || q0 + kSpT > Sq ||
                           (causal && k0 + kSpRes - 1 > q_offset + q0);

    // S^T (p[0..1]), then P^T, and dP^T (p[2..3]), then dS^T: 16 kv rows
    // x 16 query columns each
    float p[4][4];
    dot2_ab<HDP>(p, ks, vs, pr, nk, rw, qs, os, pt, nq, cw, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = cw + j * 8 + 2 * q4 + (e & 1);  // column in the tile
        float x = expf(p[j][e] * scale - lt[cl]);
        if (need_mask) {
          const int c = q0 + cl, r = row_a + (e >> 1) * 8;
          if (r >= Sk || c >= Sq || (causal && r > q_offset + c)) x = 0.f;
        }
        p[j][e] = x;
        p[2 + j][e] = x * (p[2 + j][e] - dt[cl]);
      }
    uint32_t xa[1][1][3][4];
    split_a(p[0], p[1], xa[0][0]);
    acc_xm<HDP, 1>(dva, xa, os, pt, nq, cw, lane);  // dV += P^T dO
    split_a(p[2], p[3], xa[0][0]);
    acc_xm<HDP, 1>(dka, xa, qs, pt, nq, cw, lane);  // dK += dS^T Q
  }
  mma::cp_async_wait<0>();

  float* scratch = reinterpret_cast<float*>(sp_smem4);
  __syncthreads();  // every tile read is done
  if (warp & 1) {
    pair_put<HDP>(scratch, warp - 1, dka, lane);
    pair_put<HDP>(scratch, warp, dva, lane);
  }
  __syncthreads();
  if (!(warp & 1)) {
    pair_add<HDP>(scratch, warp, dka, lane);
    pair_add<HDP>(scratch, warp + 1, dva, lane);
    store_acc<HDP>(dk, kv_bf, kv_off, kv_stride, rw, k_rows, hd, scale, dka,
                   lane);
    store_acc<HDP>(dv, kv_bf, kv_off, kv_stride, rw, k_rows, hd, 1.f, dva,
                   lane);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kSpThreads, 1)
flash_bwd_dq_split_kernel(const void* __restrict__ q,
                          const void* __restrict__ k,
                          const void* __restrict__ v,
                          const void* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          void* __restrict__ dq, int Sq, int Sk, int H, int KV,
                          int hd, int causal, int q_offset, float scale,
                          int flags) {
  constexpr int NHT = HDP / 8;
  const bool q_bf = flags & kQBf16, kv_bf = flags & kKvBf16;
  const int nq = q_bf ? 1 : 3, nk = kv_bf ? 1 : 3;
  const size_t pr = (size_t)kSpRes * (HDP + 8), pt = (size_t)kSpT * (HDP + 8);
  extern __shared__ float4 sp_smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sp_smem4);
  __nv_bfloat16* os = qs + nq * pr;
  __nv_bfloat16* ks = os + nq * pr;  // the kv tile's planes
  __nv_bfloat16* vs = ks + nk * pt;
  char* stg_k = reinterpret_cast<char*>(vs + nk * pt);  // [32][HDP] raw
  char* stg_v = stg_k + kSpT * HDP * (kv_bf ? 2 : 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int rw = (warp >> 1) * 16, cw = (warp & 1) * 16;  // q rows, kv cols
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kSpRes;  // heavy first
  const int q_rows = min(kSpRes, Sq - q0);
  const size_t kv_stride = (size_t)KV * hd, q_stride = (size_t)H * hd;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * hd;
  const size_t kv_base = (size_t)b * Sk * kv_stride + (size_t)kh * hd;
  auto stage = [&](int t) {
    const size_t off = kv_base + (size_t)t * kSpT * kv_stride;
    stage_tile<HDP, kSpT>(stg_k, k, kv_bf, off, kv_stride, Sk - t * kSpT,
                          hd, align_of(flags, kKAlign));
    stage_tile<HDP, kSpT>(stg_v, v, kv_bf, off, kv_stride, Sk - t * kSpT,
                          hd, align_of(flags, kVAlign));
    mma::cp_async_commit();
  };
  stage(0);
  split_tile<HDP, kSpRes>(qs, q, q_bf, q_off, q_stride, q_rows, hd,
                          vec_of(flags, kQAlign, q_bf));
  split_tile<HDP, kSpRes>(os, dout, q_bf, q_off, q_stride, q_rows, hd,
                          vec_of(flags, kOAlign, q_bf));
  int n_tiles = (Sk + kSpT - 1) / kSpT;
  if (causal)
    n_tiles = min(n_tiles, (q_offset + q0 + q_rows - 1) / kSpT + 1);

  // lse and D of this thread's rows g4 and g4 + 8 (0 past Sq)
  float l_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + g4 + r * 8;
    const bool ok = row < q_rows;
    l_r[r] = ok ? lse[(size_t)bh * Sq + q0 + row] : 0.f;
    d_r[r] = ok ? delta[(size_t)bh * Sq + q0 + row] : 0.f;
  }
  float dqa[NHT][4];
#pragma unroll
  for (int j = 0; j < NHT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  const int row_a = q_offset + q0 + rw + g4;  // absolute position

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kSpT;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp is done with tile t - 1
    split_stage<HDP, kSpT>(ks, stg_k, kv_bf);
    split_stage<HDP, kSpT>(vs, stg_v, kv_bf);
    __syncthreads();  // tile t (and Q, dO) split; the staging is free
    if (t + 1 < n_tiles) stage(t + 1);
    // causal: every column of the warp's half past its last row
    if (causal && k0 + cw > row_a - g4 + 15) continue;
    const bool need_mask =
        k0 + kSpT > Sk || (causal && k0 + kSpT - 1 > q_offset + q0);

    // S (p[0..1]), then P, and dP (p[2..3]), then dS: 16 query rows x 16
    // kv columns each
    float p[4][4];
    dot2_ab<HDP>(p, qs, os, pr, nq, rw, ks, vs, pt, nk, cw, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = expf(p[j][e] * scale - l_r[e >> 1]);
        if (need_mask) {
          const int col = k0 + cw + j * 8 + 2 * q4 + (e & 1);
          if (col >= Sk || (causal && col > row_a + (e >> 1) * 8)) x = 0.f;
        }
        p[2 + j][e] = x * (p[2 + j][e] - d_r[e >> 1]);
      }
    uint32_t xa[1][1][3][4];
    split_a(p[2], p[3], xa[0][0]);
    acc_xm<HDP, 1>(dqa, xa, ks, pt, nk, cw, lane);  // dQ += dS K
  }

  float* scratch = reinterpret_cast<float*>(sp_smem4);
  __syncthreads();  // every tile read is done
  if (warp & 1) pair_put<HDP>(scratch, warp >> 1, dqa, lane);
  __syncthreads();
  if (!(warp & 1)) {
    pair_add<HDP>(scratch, warp >> 1, dqa, lane);
    store_acc<HDP>(dq, q_bf, q_off, q_stride, rw, q_rows, hd, scale, dqa,
                   lane);
  }
}

// the head dim the split kernels are built for: hd rounded up to 64, 96,
// 112 or 128 (the zoo's head dims; smaller ones pad to 64)
int split_hdp(int hd) {
  return hd <= 64 ? 64 : hd <= 96 ? 96 : hd <= 112 ? 112 : 128;
}

// the flags of a split launch (dout may be null)
int split_flags(const void* q, int q_bf16, const void* k, const void* v,
                int kv_bf16, const void* dout, int hd) {
  // the largest copy that every row of the tensor allows: base address
  // and head-dim offsets both on it
  auto align = [hd](const void* p, int bf16, int shift) {
    const int row_bytes = hd * (bf16 ? 2 : 4);
    int a = 16;
    while (a > 2 && ((uintptr_t)p % a != 0 || row_bytes % a != 0)) a >>= 1;
    int code = 0;
    while ((2 << code) < a) ++code;
    return code << shift;
  };
  int f = (q_bf16 ? kQBf16 : 0) | (kv_bf16 ? kKvBf16 : 0) |
          align(q, q_bf16, kQAlign) | align(k, kv_bf16, kKAlign) |
          align(v, kv_bf16, kVAlign);
  if (dout != nullptr) f |= align(dout, q_bf16, kOAlign);
  return f;
}

template <int HDP>
int launch_split_hd(const void* q, int q_bf16, const void* k, const void* v,
                    int kv_bf16, void* out, float* lse, int B, int Sq, int Sk,
                    int H, int KV, int hd, int causal, int q_offset,
                    cudaStream_t stream) {
  auto kern = flash_split_kernel<HDP>;
  const int nq = q_bf16 ? 1 : 3, nk = kv_bf16 ? 1 : 3;
  const size_t smem =
      (size_t)(nq * kSpBQ + 2 * nk * kSpT) * (HDP + 8) *
          sizeof(__nv_bfloat16) +
      (size_t)2 * kSpT * HDP * (kv_bf16 ? 2 : 4);
  static int granted[64];
  cudaError_t e = mma::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kSpBQ - 1) / kSpBQ);
  kern<<<grid, kSpThreads, smem, stream>>>(
      q, k, v, out, lse, Sq, Sk, H, KV, hd, causal, q_offset,
      1.0f / sqrtf((float)hd),
      split_flags(q, q_bf16, k, v, kv_bf16, nullptr, hd));
  return (int)cudaGetLastError();
}

int launch_split(const void* q, int q_bf16, const void* k, const void* v,
                 int kv_bf16, void* out, float* lse, int B, int Sq, int Sk,
                 int H, int KV, int hd, int causal, int q_offset,
                 cudaStream_t s) {
  switch (split_hdp(hd)) {
#define FLASH_SPLIT_HD(n)                                                \
  case n:                                                                \
    return launch_split_hd<n>(q, q_bf16, k, v, kv_bf16, out, lse, B, Sq, \
                              Sk, H, KV, hd, causal, q_offset, s);
    FLASH_SPLIT_HD(64) FLASH_SPLIT_HD(96) FLASH_SPLIT_HD(112)
    FLASH_SPLIT_HD(128)
#undef FLASH_SPLIT_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int HDP>
int launch_bwd_split_hd(const void* q, int q_bf16, const void* k,
                        const void* v, int kv_bf16, const void* out,
                        const void* dout, const float* lse, float* delta,
                        void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                        int H, int KV, int hd, int causal, int q_offset,
                        cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t e =
      q_bf16 ? launch_delta<__nv_bfloat16>(out, dout, delta, B, Sq, H, hd,
                                           stream)
             : launch_delta<float>(out, dout, delta, B, Sq, H, hd, stream);
  if (e != cudaSuccess) return (int)e;
  const int nq = q_bf16 ? 1 : 3, nk = kv_bf16 ? 1 : 3;
  const int flags = split_flags(q, q_bf16, k, v, kv_bf16, dout, hd);
  const size_t LDB = (HDP + 8) * sizeof(__nv_bfloat16);
  const size_t slot = (size_t)(HDP / 8) * 4 * 32 * sizeof(float);

  auto dkdv = flash_bwd_dkdv_split_kernel<HDP>;
  const size_t smem_kv = std::max(
      (size_t)(2 * nk * kSpRes + 2 * nq * kSpT) * LDB +
          4 * kSpT * sizeof(float) + (size_t)2 * kSpT * HDP * (q_bf16 ? 2 : 4),
      8 * slot);
  static int granted_kv[64];
  e = mma::allow_smem(dkdv, smem_kv, granted_kv);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(B * KV, (Sk + kSpRes - 1) / kSpRes), kSpThreads, smem_kv,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, hd,
                   causal, q_offset, scale, flags);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_split_kernel<HDP>;
  const size_t smem_q = std::max(
      (size_t)(2 * nq * kSpRes + 2 * nk * kSpT) * LDB +
          (size_t)2 * kSpT * HDP * (kv_bf16 ? 2 : 4),
      4 * slot);
  static int granted_q[64];
  e = mma::allow_smem(dqk, smem_q, granted_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(B * H, (Sq + kSpRes - 1) / kSpRes), kSpThreads, smem_q,
        stream>>>(q, k, v, dout, lse, delta, dq, Sq, Sk, H, KV, hd, causal,
                  q_offset, scale, flags);
  return (int)cudaGetLastError();
}

int launch_bwd_split(const void* q, int q_bf16, const void* k, const void* v,
                     int kv_bf16, const void* out, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int Sq, int Sk, int H, int KV, int hd,
                     int causal, int q_offset, cudaStream_t s) {
  switch (split_hdp(hd)) {
#define FLASH_BWD_SPLIT_HD(n)                                               \
  case n:                                                                   \
    return launch_bwd_split_hd<n>(q, q_bf16, k, v, kv_bf16, out, dout, lse, \
                                  delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,  \
                                  causal, q_offset, s);
    FLASH_BWD_SPLIT_HD(64) FLASH_BWD_SPLIT_HD(96) FLASH_BWD_SPLIT_HD(112)
    FLASH_BWD_SPLIT_HD(128)
#undef FLASH_BWD_SPLIT_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int hd, int q_offset) {
  return B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
         hd > kHdMax || hd % 4 != 0 || q_offset < 0 ||
         (Sq + kSpT - 1) / kSpT > 65535 || (Sk + kSpT - 1) / kSpT > 65535;
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
  return launch_split(q, q_is_bf16, k, v, kv_is_bf16, out, lse, B, Sq, Sk,
                      H, KV, hd, causal, q_offset, s);
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
  return launch_bwd_split(q, q_is_bf16, k, v, kv_is_bf16, out, dout, lse,
                          delta, dq, dk, dv, B, Sq, Sk, H, KV, hd, causal,
                          q_offset, s);
}
