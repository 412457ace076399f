// Paged decode attention over a shared KV block pool, for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_tpu
// (Pallas TPU kernel, body `_kernel`; oracle kernels/ref.py::
// paged_attention_ref). One query token per serving slot attends over that
// slot's pages of the pool through its page-table row:
//   q (B, H, hd) f32|bf16; k_pool, v_pool (num_blocks, page_size, KV, cols)
//   page_table (B, n_pages) i32; pos (B,) i32  ->  out (B, H, hd) q's dtype
//   out[b, h] = softmax_{kpos <= pos[b]}(q[b,h] . K[b,kpos] / sqrt(hd)) V
// where logical row kpos of slot b lives in block page_table[b, kpos / ps],
// row kpos % ps, and kv head h / G (G = H / KV) serves query head h.
// Page formats (fmt): 0 f32 and 1 bf16 pages hold values (cols = hd);
// 2 int8 (cols = hd) and 3 packed int4 (cols = hd/2; even dim in the low
// nibble, sign-extended) hold codes times a per-row per-kv-head f32 scale
// (k_scale/v_scale (num_blocks, page_size, KV)); 4 vq2 (cols = hd/4) holds
// 4-bit indices (2j low nibble, 2j+1 high, unsigned) into the kv head's
// (16, 2) codebook (k_cb/v_cb (KV, 16, 2) f32), times the row's scale.
// Each decoded value is the expression of kernels/kv_quant.py (code * scale,
// codebook entry * scale), so the plain version sees the same K and V.
//
// What bounds it on the H100: bytes. A slot reads each live row of its pages
// once (K and V, plus scales) and does 4 * hd FLOPs per row and query head;
// at G <= 8 that is < 4 FLOP/byte for f32 pages, far below the card's
// FP32 ridge (~20 FLOP/byte), so the bound is the live pages' bytes over
// 3.35 TB/s.
//
// Design: one CTA per (kv head, slot), 128 threads; all G query heads of the
// kv head share the CTA, so GQA needs no head expansion. The CTA walks the
// slot's logical pages 0 .. pos/ps (clamped to the table), stopping at
// pos's page: rows past pos (the last page's tail, stale rows of a recycled
// block, the scratch block 0 that idle slots map) are never loaded. The
// reference masks them to -1e30 instead, and exp(-1e30 - m) is exactly 0 in
// f32 once page 0's row 0 (always live) has made the running max m finite,
// so skipping them gives the same result. Per page: decode the live rows of
// K and V into shared memory (f32), one warp per (head, row) dot product,
// one warp per head for the running max/sum (online softmax), then each
// thread updates its own (head, dim) accumulators. The vq2 codebooks sit in
// shared memory for the whole CTA. Output acc / max(l, 1e-30) in q's dtype.
// Simple first: no page split across CTAs, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kVqK = 16;
constexpr int kVqD = 2;

enum Fmt { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3, kVq2 = 4 };

// value of head dim d of the row starting at `row` (in elements of the pool)
template <int FMT>
__device__ __forceinline__ float decode(const void* __restrict__ pool,
                                        size_t row, int d, float scale,
                                        const float* cb) {
  if constexpr (FMT == kF32) {
    return static_cast<const float*>(pool)[row + d];
  } else if constexpr (FMT == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[row + d]);
  } else if constexpr (FMT == kInt8) {
    return (float)static_cast<const int8_t*>(pool)[row + d] * scale;
  } else if constexpr (FMT == kInt4) {
    const uint8_t byte = static_cast<const uint8_t*>(pool)[row + (d >> 1)];
    // move the nibble to the top of a signed byte, then shift it back down
    // arithmetically: sign extension, as kv_quant.unpack_int4
    const int8_t top = (int8_t)((d & 1) ? (byte & 0xF0) : (byte << 4));
    const int code = (int)top >> 4;
    return (float)code * scale;
  } else {
    const uint8_t byte = static_cast<const uint8_t*>(pool)[row + (d >> 2)];
    const int idx = ((d >> 1) & 1) ? (byte >> 4) : (byte & 0x0F);
    return cb[idx * kVqD + (d & 1)] * scale;
  }
}

template <int FMT, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const float* __restrict__ k_cb,
                       const float* __restrict__ v_cb,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ pos_in,
                       QT* __restrict__ out, int H, int KV, int hd, int cols,
                       int page_size, int n_pages, int num_blocks,
                       float sm_scale) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                        // (G, hd)
  float* acc_s = q_s + G * hd;              // (G, hd)
  float* k_s = acc_s + G * hd;              // (page_size, hd)
  float* v_s = k_s + page_size * hd;        // (page_size, hd)
  float* p_s = v_s + page_size * hd;        // (G, page_size) scores/probs
  float* m_s = p_s + G * page_size;         // (G) running max
  float* l_s = m_s + G;                     // (G) running sum
  float* a_s = l_s + G;                     // (G) rescale of this page
  float* cb_s = a_s + G;                    // (2, 16, 2) vq2 codebooks

  const size_t q_off = ((size_t)b * H + (size_t)kv * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    if constexpr (sizeof(QT) == 2) {
      q_s[e] = __bfloat162float(q[q_off + e]);
    } else {
      q_s[e] = q[q_off + e];
    }
    acc_s[e] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if constexpr (FMT == kVq2) {
    if (tid < 2 * kVqK * kVqD) {
      const int n = kVqK * kVqD;
      cb_s[tid] = tid < n ? k_cb[kv * n + tid] : v_cb[kv * n + tid - n];
    }
  }
  __syncthreads();

  const int p = max(pos_in[b], 0);
  const int last_page = min(p / page_size, n_pages - 1);
  for (int pg = 0; pg <= last_page; ++pg) {
    int blk = page_table[(size_t)b * n_pages + pg];
    blk = min(max(blk, 0), num_blocks - 1);
    // live rows of this page: kpos = pg * page_size + r <= p
    const int rows = min(page_size, p - pg * page_size + 1);

    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd;
      const int d = e - r * hd;
      const size_t row = ((size_t)blk * page_size + r) * KV + kv;
      float ks = 1.f, vs = 1.f;
      if constexpr (FMT >= kInt8) {
        ks = k_scale[row];
        vs = v_scale[row];
      }
      k_s[e] = decode<FMT>(k_pool, row * cols, d, ks, cb_s);
      v_s[e] = decode<FMT>(v_pool, row * cols, d, vs, cb_s + kVqK * kVqD);
    }
    __syncthreads();

    // scores: one warp per (head, row)
    for (int i = warp; i < G * rows; i += kWarps) {
      const int g = i / rows;
      const int r = i - g * rows;
      const float* qg = q_s + g * hd;
      const float* kr = k_s + r * hd;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += qg[d] * kr[d];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) p_s[g * page_size + r] = s * sm_scale;
    }
    __syncthreads();

    // online softmax statistics: one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* pg_s = p_s + g * page_size;
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, pg_s[r]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float pr = expf(pg_s[r] - m_new);
        pg_s[r] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // accumulators: each thread owns (head, dim) elements
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pg_s = p_s + g * page_size;
      float a = acc_s[e] * a_s[g];
      for (int r = 0; r < rows; ++r) a += pg_s[r] * v_s[r * hd + d];
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * hd; e += kThreads) {
    const float o = acc_s[e] / fmaxf(l_s[e / hd], 1e-30f);
    if constexpr (sizeof(QT) == 2) {
      out[q_off + e] = __float2bfloat16(o);
    } else {
      out[q_off + e] = o;
    }
  }
}

size_t smem_bytes(int G, int hd, int page_size) {
  return sizeof(float) * ((size_t)2 * G * hd + (size_t)2 * page_size * hd +
                          (size_t)G * page_size + 3 * G + 2 * kVqK * kVqD);
}

template <int FMT, typename QT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const float* k_cb,
           const float* v_cb, const int32_t* page_table, const int32_t* pos,
           void* out, int B, int H, int KV, int hd, int cols, int page_size,
           int n_pages, int num_blocks, cudaStream_t stream) {
  auto kern = paged_attention_kernel<FMT, QT>;
  const size_t smem = smem_bytes(H / KV, hd, page_size);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  paged_attention_kernel<FMT, QT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), k_pool, v_pool, k_scale, v_scale, k_cb, v_cb,
      page_table, pos, static_cast<QT*>(out), H, KV, hd, cols, page_size,
      n_pages, num_blocks, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch(int fmt, const void* q, const void* k_pool, const void* v_pool,
             const float* k_scale, const float* v_scale, const float* k_cb,
             const float* v_cb, const int32_t* page_table, const int32_t* pos,
             void* out, int B, int H, int KV, int hd, int cols,
             int page_size, int n_pages, int num_blocks,
             cudaStream_t stream) {
#define PA_LAUNCH(F)                                                        \
  return launch<F, QT>(q, k_pool, v_pool, k_scale, v_scale, k_cb, v_cb,     \
                       page_table, pos, out, B, H, KV, hd, cols, page_size, \
                       n_pages, num_blocks, stream)
  switch (fmt) {
    case kF32: PA_LAUNCH(kF32);
    case kBF16: PA_LAUNCH(kBF16);
    case kInt8: PA_LAUNCH(kInt8);
    case kInt4: PA_LAUNCH(kInt4);
    case kVq2: PA_LAUNCH(kVq2);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_is_bf16: 0 -> q and out are float32, 1 -> bfloat16. fmt: page format
// (0 f32, 1 bf16, 2 int8, 3 int4, 4 vq2); scales are null for 0/1 and the
// codebooks null unless fmt is 4. Returns cudaGetLastError() after the
// launch (or the error that refused it).
extern "C" int paged_attention_launch(
    const void* q, int q_is_bf16, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const float* k_cb,
    const float* v_cb, const int32_t* page_table, const int32_t* pos,
    void* out, int B, int H, int KV, int hd, int cols, int page_size,
    int n_pages, int num_blocks, int fmt, void* stream) {
  if (KV < 1 || H % KV != 0 || page_size < 1 || n_pages < 1 ||
      num_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_is_bf16)
    return dispatch<__nv_bfloat16>(fmt, q, k_pool, v_pool, k_scale, v_scale,
                                   k_cb, v_cb, page_table, pos, out, B, H, KV,
                                   hd, cols, page_size, n_pages, num_blocks,
                                   s);
  return dispatch<float>(fmt, q, k_pool, v_pool, k_scale, v_scale, k_cb,
                         v_cb, page_table, pos, out, B, H, KV, hd, cols,
                         page_size, n_pages, num_blocks, s);
}
