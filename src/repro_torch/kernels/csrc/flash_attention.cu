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
// (989 TFLOP/s, ~295 FLOP/byte). With f32 inputs every FLOP is bound at
// the FP32 rate. With bf16 q/k, the q.k half is exact on bf16 tensor cores
// with an f32 sum, while p.v stays at the FP32 rate because p is kept in
// f32; the function's bound is then the sum of the two halves' times. This
// kernel runs both products on the FP32 CUDA cores.
//
// Design: one CTA of 128 threads per (batch x head, 64-row query block);
// query head h reads kv head h/G, so GQA needs no head expansion. The CTA
// keeps its query block transposed in shared memory as f32 and walks the
// kv range in 64-row tiles (K transposed, V as is, both converted to f32
// on load). Each thread owns 8 query rows: for the scores it computes an
// 8 x 4 register tile (float4 shared-memory reads, 32 FMAs per 3 loads),
// for the output an 8 x 8 tile of the accumulator (hd <= 128). The 16
// threads of a row group sit in one half-warp, so the row max and sum of
// the online softmax are shuffles. P goes through shared memory (reusing
// K's buffer) to the P.V product. Causal: kv tiles wholly above the
// diagonal (first column > q_offset + the block's last row) are never
// loaded; inside a tile the mask sets the score to -1e30, whose exp is
// exactly 0 once the running max is finite, which it is after tile 0
// (column 0 is live for every row when q_offset >= 0). Rows past Sq and
// columns past Sk are zero-filled in shared memory and never written.
// Shared memory ~100 KB, so two CTAs share an SM. Simple first: no tensor
// cores (mma/wgmma), no TMA, no warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), Sq, Sk, H, KV, hd,
      causal, q_offset, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// q_is_bf16 / kv_is_bf16: 0 -> float32, 1 -> bfloat16 (out has q's type).
// All tensors contiguous in the layouts above. Returns cudaGetLastError()
// after the launch (or the error that refused it).
extern "C" int flash_attention_launch(const void* q, int q_is_bf16,
                                      const void* k, const void* v,
                                      int kv_is_bf16, void* out, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int causal, int q_offset,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
      hd > kHdMax || hd % 4 != 0 || q_offset < 0 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
