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
// once (K and V, plus scales) and does 4 * hd FLOPs per row and query head:
// at G <= 8 that is at most G/2 FLOP a byte of f32 pages, below the card's
// FP32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP/byte); int4 and vq2 pages
// at G = 8 come near it. So the design is about keeping enough bytes in
// flight on all 132 SMs, with the arithmetic on the CUDA cores.
//
// Design (flash-decoding):
// - The KV walk is split over CTAs. The grid is (split, kv head x head
//   chunk, slot); split s walks the slot's logical pages
//   [s * pps, (s + 1) * pps), stopping at pos's page (clamped to the table):
//   rows past pos (the last page's tail, stale rows of a recycled block, the
//   scratch block 0 that idle slots map) are never loaded. The reference
//   masks them to -1e30 instead, and exp(-1e30 - m) is exactly 0 in f32
//   once a live row has made the running max m finite, so skipping them
//   gives the same result. Splits past the slot's last live page exit at
//   once. pps (pages per split) comes from the host's split plan
//   (kernels/paged_attention.py::split_plan), a function of page_size, hd,
//   G and the page format only: a slot's sums run in the same order alone,
//   in any batch and on every call, so its output is bitwise the same.
// - Pages stream through a ring of two shared-memory buffers (one where
//   two do not fit) with cp.async (16-byte copies where the rows and the
//   pool allow, else 8 or 4 bytes, else plain loads for rows narrower than
//   4 bytes): the next page's K and V rows (and scales) load while the
//   current one is scored, and the page table's entries of the split are
//   read once, at the start. One __syncthreads a page guards the ring. A
//   deeper ring measured no faster: once the bytes are in flight the
//   kernel is bound by its instructions (PERF.md).
// - A row of a page goes to one "unit": lanes_per_row lanes of a warp, each
//   holding dims_per_lane (4 or 8) head dims of q and of the accumulators
//   for the CTA's heads (heads_per_cta, up to 8) in registers. A lane
//   decodes its dims of the K row from shared memory (int8, int4 nibbles and
//   vq2 indices against the shared codebook in registers), the unit sums the
//   dot products with shuffles, and each unit keeps its own running max,
//   sum and accumulators (online softmax), with no block-wide barrier. Units
//   merge once at the end of the split: shuffles within a warp, then shared
//   memory across the 4 warps. With 4 or 8 heads the scores are
//   reduce-scattered (9 shuffles for 8 heads, not 40), each lane runs one
//   head's softmax, and the heads' weights reach every lane by shuffles:
//   GQA rows cost a third of the instructions they would otherwise.
// - A split writes its partial (max, sum, acc[heads, hd]) in f32 to
//   scratch; a second kernel merges a slot's live splits (their count from
//   pos, on the device) in split order and writes acc / max(sum, 1e-30) in
//   q's dtype. With a single split (n_pages <= pps) the split kernel writes
//   the output itself, the same bits the merge would give (weights exp(0)).
// - Head dims above 256 take a "wide" variant: one query head a CTA, q and
//   the accumulators in shared memory, a warp a unit.
// Tensor cores are not used: they are exact here only for int8/int4 codes
// against bf16 q.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int kVqK = 16;
constexpr int kVqD = 2;
constexpr int kCbBytes = 2 * kVqK * kVqD * 4;  // K and V codebooks, f32
constexpr int kSlack = 32;  // bytes a lane may read past a row's last dim
constexpr int kMaxSmem = 227 * 1024;

enum Fmt { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3, kVq2 = 4 };

// Every argument, in the order of the int64 array the wrapper passes.
struct Args {
  const void* q;
  long long q_bf16;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const float* k_cb;
  const float* v_cb;
  const int32_t* page_table;
  const int32_t* pos;
  void* out;
  float* part;  // (B, KV, n_splits, G, hd) acc, then (..., G, 2) max, sum
  long long B, H, KV, hd, row_bytes, page_size, n_pages, num_blocks, fmt;
  long long pages_per_split, n_splits, stages, heads_per_cta, dims_per_lane;
  long long lanes_per_row, cp_bytes, copy_lanes;
  long long stream;
};
constexpr int kNArgs = sizeof(Args) / sizeof(long long);
static_assert(sizeof(Args) == kNArgs * 8, "Args must be int64 slots");

// What a kernel reads of Args, in int form.
struct Shape {
  int B, H, KV, G, hd, row_bytes, rs, ps, n_pages, num_blocks, pps,
      n_splits, stages, stage_bytes, lpr, cp, cpl;
  float sm_scale;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Bytes of one ring buffer: K rows, V rows (each padded to 16 bytes), then
// the K and V scales of the page's rows.
__host__ __device__ inline int stage_bytes(int ps, int row_bytes,
                                           bool scaled) {
  return round16(2 * ps * round16(row_bytes) + (scaled ? 8 * ps : 0));
}

template <typename QT>
__device__ __forceinline__ float to_f32(QT x) {
  if constexpr (sizeof(QT) == 2) {
    return __bfloat162float(x);
  } else {
    return x;
  }
}

template <typename QT>
__device__ __forceinline__ QT from_f32(float x) {
  if constexpr (sizeof(QT) == 2) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// signed 4-bit code in bits [4j, 4j + 4) of w, as kv_quant.unpack_int4
__device__ __forceinline__ float nibble(uint32_t w, int j) {
  return (float)((int)(w << (28 - 4 * j)) >> 28);
}

// Dims d0 .. d0 + DPL - 1 of a staged row (16-byte aligned in shared
// memory) into x; dims at or past hd (nvalid of them are real) read 0.
template <int FMT, int DPL>
__device__ __forceinline__ void decode(const unsigned char* row, int d0,
                                       int nvalid, float scale,
                                       const float* cb, float (&x)[DPL]) {
  if (nvalid <= 0) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) x[j] = 0.f;
    return;
  }
#pragma unroll
  for (int i = 0; i < DPL / 4; ++i) {
    float* y = x + 4 * i;
    if constexpr (FMT == kF32) {
      const float4 t = reinterpret_cast<const float4*>(row + 4 * d0)[i];
      y[0] = t.x; y[1] = t.y; y[2] = t.z; y[3] = t.w;
    } else if constexpr (FMT == kBF16) {
      const uint2 t = reinterpret_cast<const uint2*>(row + 2 * d0)[i];
      y[0] = bf16_lo(t.x); y[1] = bf16_hi(t.x);
      y[2] = bf16_lo(t.y); y[3] = bf16_hi(t.y);
    } else if constexpr (FMT == kInt8) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(row + d0)[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = (float)(int8_t)(w >> (8 * j)) * scale;
    } else if constexpr (FMT == kInt4) {
      const uint32_t w = reinterpret_cast<const uint16_t*>(row + d0 / 2)[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = nibble(w, j) * scale;
    } else {
      const uint32_t w = row[d0 / 4 + i];
      const float* lo = cb + (w & 15u) * kVqD;
      const float* hi = cb + (w >> 4) * kVqD;
      y[0] = lo[0] * scale; y[1] = lo[1] * scale;
      y[2] = hi[0] * scale; y[3] = hi[1] * scale;
    }
  }
  if (nvalid < DPL) {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (j >= nvalid) x[j] = 0.f;
  }
}

// Dim d of a staged row: the wide variant's decode, one dim at a time.
template <int FMT>
__device__ __forceinline__ float decode1(const unsigned char* row, int d,
                                         float scale, const float* cb) {
  if constexpr (FMT == kF32) {
    return reinterpret_cast<const float*>(row)[d];
  } else if constexpr (FMT == kBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  } else if constexpr (FMT == kInt8) {
    return (float)(int8_t)row[d] * scale;
  } else if constexpr (FMT == kInt4) {
    return nibble(row[d >> 1], d & 1) * scale;
  } else {
    const uint32_t byte = row[d >> 2];
    const uint32_t idx = ((d >> 1) & 1) ? (byte >> 4) : (byte & 15u);
    return cb[idx * kVqD + (d & 1)] * scale;
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The slot's walk: its last live page and this split's pages [first, end).
struct Walk {
  int p, last_page, first, end;
};
__device__ __forceinline__ Walk walk(const Args& a, const Shape& sh, int b,
                                     int s) {
  Walk w;
  w.p = max(a.pos[b], 0);
  w.last_page = min(w.p / sh.ps, sh.n_pages - 1);
  w.first = s * sh.pps;
  w.end = min(w.first + sh.pps, w.last_page + 1);
  return w;
}

// The split's block ids (clamped to the pool) into shared memory, read
// once at the start so that no page's copy waits on a global load.
__device__ __forceinline__ void load_blocks(const Args& a, const Shape& sh,
                                            const Walk& w, int b,
                                            int* blk_s) {
  for (int i = threadIdx.x; i < w.end - w.first; i += kThreads) {
    const int blk = a.page_table[(size_t)b * sh.n_pages + w.first + i];
    blk_s[i] = min(max(blk, 0), sh.num_blocks - 1);
  }
  __syncthreads();
}

// Stage page `i` of the split (if it exists) into ring buffer i % stages:
// its live rows of K and V for kv head `kv`, and their scales; always
// commits one cp.async group.
template <bool SCALED>
__device__ __forceinline__ void stage_page(const Args& a, const Shape& sh,
                                           const Walk& w, const int* blk_s,
                                           int kv, int i,
                                           unsigned char* ring) {
  const int pg = w.first + i;
  if (pg < w.end) {
    const int blk = blk_s[i];
    const int rows = min(sh.ps, w.p - pg * sh.ps + 1);
    unsigned char* st = ring + (size_t)(i & (sh.stages - 1)) * sh.stage_bytes;
    // row r of this kv head: pool row (blk * ps + r) * KV + kv
    const size_t row0 = (size_t)blk * sh.ps * sh.KV + kv;
    const size_t stride = (size_t)sh.KV * sh.row_bytes;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cpl_log = __ffs(sh.cpl) - 1;
    const int per_warp = 32 >> cpl_log;  // rows a warp copies at once
    const int step = kWarps * per_warp;
    const int r0 = warp * per_warp + (lane >> cpl_log);
    const int c0 = lane & (sh.cpl - 1);
    for (int which = 0; which < 2; ++which) {
      const unsigned char* src = (which ? a.v_pool : a.k_pool) +
                                 row0 * sh.row_bytes + r0 * stride;
      unsigned char* dst = st + (size_t)(which * sh.ps + r0) * sh.rs;
      for (int r = r0; r < rows;
           r += step, src += step * stride, dst += step * sh.rs) {
        if (sh.cp) {
          for (int c = c0 * sh.cp; c < sh.row_bytes; c += sh.cpl * sh.cp)
            cp_async(dst + c, src + c, sh.cp);
        } else {
          for (int c = c0; c < sh.row_bytes; c += sh.cpl) dst[c] = src[c];
        }
      }
    }
    if constexpr (SCALED) {
      float* sc = reinterpret_cast<float*>(st + 2 * sh.ps * sh.rs);
      for (int t = threadIdx.x; t < 2 * rows; t += kThreads) {
        const int which = t >= rows;
        const int r = t - which * rows;
        cp_async(sc + which * sh.ps + r,
                 (which ? a.v_scale : a.k_scale) + row0 + (size_t)r * sh.KV,
                 4);
      }
    }
  }
  cp_commit();
}

// The ring's turn for page i (1 or 2 buffers): wait for it, then start
// page i + 1 into the buffer every thread has finished with.
template <bool SCALED>
__device__ __forceinline__ void ring_turn(const Args& a, const Shape& sh,
                                          const Walk& w, const int* blk_s,
                                          int kv, int i,
                                          unsigned char* ring) {
  if (sh.stages == 1) {
    __syncthreads();
    stage_page<SCALED>(a, sh, w, blk_s, kv, i, ring);
  }
  cp_wait_all();
  __syncthreads();
  if (sh.stages == 2) stage_page<SCALED>(a, sh, w, blk_s, kv, i + 1, ring);
}

// Merge the 4 warps' (max, sum, acc) in shared memory (red: (4, GT, hd)
// acc, red_ml: (4, GT, 2)) in warp order and write the split's result: the
// output itself when the slot has one split, else the partial.
template <typename QT>
__device__ __forceinline__ void finish_split(const Args& a, const Shape& sh,
                                             int b, int kv, int h0, int g0,
                                             int GT, int s, const float* red,
                                             const float* red_ml) {
  for (int e = threadIdx.x; e < GT * sh.hd; e += kThreads) {
    const int g = e / sh.hd;
    const int d = e - g * sh.hd;
    float M = red_ml[g * 2];
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_ml[(w * GT + g) * 2]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = red_ml + (w * GT + g) * 2;
      const float wt = expf(ml[0] - M);
      L = fmaf(ml[1], wt, L);
      A = fmaf(red[(w * GT + g) * sh.hd + d], wt, A);
    }
    if (sh.n_splits == 1) {
      static_cast<QT*>(a.out)[((size_t)b * sh.H + h0 + g) * sh.hd + d] =
          from_f32<QT>(A / fmaxf(L, 1e-30f));
    } else {
      // partial of (slot, kv head, split, head of the kv head)
      const size_t slot = ((size_t)b * sh.KV + kv) * sh.n_splits + s;
      const size_t row = slot * sh.G + g0 + g;
      a.part[row * sh.hd + d] = A;
      if (d == 0) {
        float* ml = a.part + (size_t)sh.B * sh.KV * sh.n_splits * sh.G * sh.hd;
        ml[row * 2] = M;
        ml[row * 2 + 1] = L;
      }
    }
  }
}

// The split kernel: GT query heads of one kv head, DPL head dims a lane.
template <int FMT, typename QT, int GT, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const Args a, const Shape sh) {
  constexpr bool kScaled = FMT >= kInt8;
  constexpr int RU = GT >= 4 ? 1 : 4 / GT;  // rows a unit works at once
  constexpr int kLogGT = GT == 8 ? 3 : GT == 4 ? 2 : GT == 2 ? 1 : 0;
  const int s = blockIdx.x;
  const int chunks = sh.G / GT;
  const int kv = blockIdx.y / chunks;
  const int g0 = (blockIdx.y - kv * chunks) * GT;
  const int h0 = kv * sh.G + g0;
  const int b = blockIdx.z;
  const Walk w = walk(a, sh, b, s);
  if (w.first > w.last_page) return;
  const int npg = w.end - w.first;

  extern __shared__ __align__(16) unsigned char smem[];
  float* cb_s = reinterpret_cast<float*>(smem);
  int* blk_s = reinterpret_cast<int*>(smem + kCbBytes);
  unsigned char* ring = smem + kCbBytes + round16(4 * sh.pps);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (FMT == kVq2) {
    if (tid < kCbBytes / 4) {
      const int n = kVqK * kVqD;
      cb_s[tid] = tid < n ? a.k_cb[kv * n + tid] : a.v_cb[kv * n + tid - n];
    }
  }
  load_blocks(a, sh, w, b, blk_s);
  if (sh.stages == 2) stage_page<kScaled>(a, sh, w, blk_s, kv, 0, ring);

  // this lane's head dims and unit
  const int li = lane & (sh.lpr - 1);
  const int d0 = li * DPL;
  const int nvalid = min(DPL, sh.hd - d0);
  const int lpr_log = __ffs(sh.lpr) - 1;
  const int rpw = 32 >> lpr_log;
  const int n_units = kWarps * rpw;
  const int units_log = __ffs(n_units) - 1;
  const int unit = warp * rpw + (lane >> lpr_log);

  float q[GT][DPL], acc[GT][DPL], m[GT], l[GT];
  // GT >= 4 heads a row whose group has a lane for each head: the scores
  // are reduce-scattered, a lane keeps one head's max and sum (m_own,
  // l_own) and the others read them with shuffles
  const bool scatter = GT >= 4 && sh.lpr >= GT;
  const int shift = scatter ? __ffs(sh.lpr) - 1 - kLogGT : 0;
  const int gbase = lane & ~(sh.lpr - 1);
  float m_own = kNegInf, l_own = 0.f;
  const QT* qp = static_cast<const QT*>(a.q) + ((size_t)b * sh.H + h0) * sh.hd;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      q[g][j] = j < nvalid ? to_f32<QT>(qp[g * sh.hd + d0 + j]) : 0.f;
      acc[g][j] = 0.f;
    }
  }

  for (int i = 0; i < npg; ++i) {
    ring_turn<kScaled>(a, sh, w, blk_s, kv, i, ring);
    const unsigned char* st =
        ring + (size_t)(i & (sh.stages - 1)) * sh.stage_bytes;
    const float* scales = reinterpret_cast<const float*>(st + 2 * sh.ps * sh.rs);
    const int pg = w.first + i;
    const int rows = min(sh.ps, w.p - pg * sh.ps + 1);
    // row i * ps + r of the split goes to unit (i * ps + r) % n_units
    const int start = (unit - i * sh.ps) & (n_units - 1);
    const int per_unit = (rows + n_units - 1) >> units_log;
    if (scatter) {
      for (int k = 0; k < per_unit; ++k) {
        const int r = start + k * n_units;
        const bool live = r < rows;
        float x[DPL], v[GT];
        decode<FMT, DPL>(st + (size_t)r * sh.rs, d0, live ? nvalid : 0,
                         kScaled && live ? scales[r] : 1.f, cb_s, x);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) t = fmaf(q[g][j], x[j], t);
          v[g] = t;
        }
        // reduce-scatter: each halving step sends half the heads' partial
        // sums to the partner lane and keeps the other half, so after
        // log2(GT) steps a lane holds one head's sum over its lanes; the
        // remaining steps sum that head over the rest of the row group
        int o = sh.lpr >> 1;
#pragma unroll
        for (int step = 0; step < kLogGT; ++step) {
          const bool hi = (lane & o) != 0;
          constexpr int kMax = GT / 2;
#pragma unroll
          for (int j = 0; j < kMax; ++j) {
            const int half = GT >> (step + 1);
            if (j < half) {
              const float send = hi ? v[j] : v[j + half];
              const float keep = hi ? v[j + half] : v[j];
              v[j] = keep + __shfl_xor_sync(kFull, send, o);
            }
          }
          o >>= 1;
        }
        for (; o; o >>= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
        // the online softmax of this lane's head
        float al = 1.f, pr = 0.f;
        if (live) {
          const float sg = v[0] * sh.sm_scale;
          if (sg > m_own) {
            al = expf(m_own - sg);
            m_own = sg;
          }
          pr = expf(sg - m_own);
          l_own = l_own * al + pr;
        }
        decode<FMT, DPL>(st + (size_t)(sh.ps + r) * sh.rs, d0,
                         live ? nvalid : 0,
                         kScaled && live ? scales[sh.ps + r] : 1.f,
                         cb_s + kVqK * kVqD, x);
        // every head's weight from the lanes that hold it; the rescale
        // only when some head's max moved (a factor of exactly 1 else)
        const bool rescale = __any_sync(kFull, al != 1.f);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const int src = gbase + (g << shift);
          const float pg = __shfl_sync(kFull, pr, src);
          if (rescale) {
            const float ag = __shfl_sync(kFull, al, src);
#pragma unroll
            for (int j = 0; j < DPL; ++j) acc[g][j] *= ag;
          }
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(pg, x[j], acc[g][j]);
        }
      }
      continue;
    }
    // a unit takes its rows RU at a time, so their dot products, shuffles
    // and exponentials overlap
    for (int k0 = 0; k0 < per_unit; k0 += RU) {
      int r[RU];
      bool live[RU];
      float sc[RU][GT];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        r[u] = start + (k0 + u) * n_units;
        live[u] = r[u] < rows;
        float x[DPL];
        decode<FMT, DPL>(st + (size_t)r[u] * sh.rs, d0, live[u] ? nvalid : 0,
                         kScaled && live[u] ? scales[r[u]] : 1.f, cb_s, x);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) t = fmaf(q[g][j], x[j], t);
          sc[u][g] = t;
        }
      }
      for (int o = sh.lpr >> 1; o; o >>= 1) {
#pragma unroll
        for (int u = 0; u < RU; ++u) {
#pragma unroll
          for (int g = 0; g < GT; ++g)
            sc[u][g] += __shfl_xor_sync(kFull, sc[u][g], o);
        }
      }
      float xv[RU][DPL];
#pragma unroll
      for (int u = 0; u < RU; ++u)
        decode<FMT, DPL>(st + (size_t)(sh.ps + r[u]) * sh.rs, d0,
                         live[u] ? nvalid : 0,
                         kScaled && live[u] ? scales[sh.ps + r[u]] : 1.f,
                         cb_s + kVqK * kVqD, xv[u]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          sc[u][g] *= sh.sm_scale;
          if (live[u]) mx = fmaxf(mx, sc[u][g]);
        }
        if (mx > m[g]) {
          const float al = expf(m[g] - mx);
          l[g] *= al;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[g][j] *= al;
          m[g] = mx;
        }
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          if (!live[u]) continue;
          const float pr = expf(sc[u][g] - mx);
          l[g] += pr;
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[g][j] = fmaf(pr, xv[u][j], acc[g][j]);
        }
      }
    }
  }

  if (scatter) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = __shfl_sync(kFull, m_own, gbase + (g << shift));
      l[g] = __shfl_sync(kFull, l_own, gbase + (g << shift));
    }
  }
  // merge the units of a warp (butterfly over the row groups)
  for (int o = sh.lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a0 = expf(m[g] - mn), a1 = expf(mo - mn);
      l[g] = l[g] * a0 + lo * a1;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const float ao = __shfl_xor_sync(kFull, acc[g][j], o);
        acc[g][j] = acc[g][j] * a0 + ao * a1;
      }
      m[g] = mn;
    }
  }
  // then the warps, through shared memory (the ring is free once all
  // threads are past the last page)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  float* red_ml = red + kWarps * GT * sh.hd;
  if (lane < sh.lpr) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        if (j < nvalid) red[(warp * GT + g) * sh.hd + d0 + j] = acc[g][j];
      if (li == 0) {
        red_ml[(warp * GT + g) * 2] = m[g];
        red_ml[(warp * GT + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  finish_split<QT>(a, sh, b, kv, h0, g0, GT, s, red, red_ml);
}

// The wide variant (hd > 256): one query head a CTA; q (hd) and each
// warp's acc (hd) in shared memory, a warp a unit, lanes strided over dims.
template <int FMT, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_split_wide_kernel(const Args a, const Shape sh) {
  constexpr bool kScaled = FMT >= kInt8;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int kv = h / sh.G;
  const int b = blockIdx.z;
  const Walk w = walk(a, sh, b, s);
  if (w.first > w.last_page) return;
  const int npg = w.end - w.first;

  extern __shared__ __align__(16) unsigned char smem[];
  float* cb_s = reinterpret_cast<float*>(smem);
  int* blk_s = reinterpret_cast<int*>(smem + kCbBytes);
  float* q_s = reinterpret_cast<float*>(smem + kCbBytes + round16(4 * sh.pps));
  float* red = q_s + round16(4 * sh.hd) / 4;     // (4, hd) acc
  float* red_ml = red + kWarps * sh.hd;          // (4, 2) max, sum
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(red_ml) + round16(kWarps * 2 * 4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (FMT == kVq2) {
    if (tid < kCbBytes / 4) {
      const int n = kVqK * kVqD;
      cb_s[tid] = tid < n ? a.k_cb[kv * n + tid] : a.v_cb[kv * n + tid - n];
    }
  }
  const QT* qp = static_cast<const QT*>(a.q) + ((size_t)b * sh.H + h) * sh.hd;
  for (int d = tid; d < sh.hd; d += kThreads) q_s[d] = to_f32<QT>(qp[d]);
  float* acc = red + warp * sh.hd;
  for (int d = lane; d < sh.hd; d += 32) acc[d] = 0.f;
  load_blocks(a, sh, w, b, blk_s);
  if (sh.stages == 2) stage_page<kScaled>(a, sh, w, blk_s, kv, 0, ring);

  float m = kNegInf, l = 0.f;
  for (int i = 0; i < npg; ++i) {
    ring_turn<kScaled>(a, sh, w, blk_s, kv, i, ring);
    const unsigned char* st =
        ring + (size_t)(i & (sh.stages - 1)) * sh.stage_bytes;
    const float* scales = reinterpret_cast<const float*>(st + 2 * sh.ps * sh.rs);
    const int pg = w.first + i;
    const int rows = min(sh.ps, w.p - pg * sh.ps + 1);
    for (int r = (warp - i * sh.ps) & (kWarps - 1); r < rows; r += kWarps) {
      const unsigned char* kr = st + (size_t)r * sh.rs;
      const unsigned char* vr = st + (size_t)(sh.ps + r) * sh.rs;
      const float ks = kScaled ? scales[r] : 1.f;
      const float vs = kScaled ? scales[sh.ps + r] : 1.f;
      float t = 0.f;
      for (int d = lane; d < sh.hd; d += 32)
        t = fmaf(q_s[d], decode1<FMT>(kr, d, ks, cb_s), t);
#pragma unroll
      for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
      const float sg = t * sh.sm_scale;
      float al = 1.f;
      if (sg > m) {
        al = expf(m - sg);
        l *= al;
        m = sg;
      }
      const float pr = expf(sg - m);
      l += pr;
      for (int d = lane; d < sh.hd; d += 32)
        acc[d] = fmaf(pr, decode1<FMT>(vr, d, vs, cb_s + kVqK * kVqD),
                      acc[d] * al);
    }
  }
  if (lane == 0) {
    red_ml[warp * 2] = m;
    red_ml[warp * 2 + 1] = l;
  }
  __syncthreads();
  finish_split<QT>(a, sh, b, kv, h, h - kv * sh.G, 1, s, red, red_ml);
}

// Merge a slot's live splits in split order: one CTA per (query head,
// slot), a thread per head dim. Every thread reckons the max and the sum
// itself, in the same order, so all hold the same bits.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const Args a, const Shape sh) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kv = h / sh.G;
  const Walk w = walk(a, sh, b, 0);
  const int n_live = w.last_page / sh.pps + 1;
  // row of split s: (slot, kv head, split, head of the kv head)
  const size_t row0 = ((size_t)b * sh.KV + kv) * sh.n_splits * sh.G + h -
                      (size_t)kv * sh.G;
  const size_t stride = sh.G;
  const float* ml =
      a.part + (size_t)sh.B * sh.KV * sh.n_splits * sh.G * sh.hd;
  // each split's weight exp(m_s - M) and sum, read into shared memory a
  // tile of splits at a time; every thread adds the splits in split order
  constexpr int kTile = 512;
  __shared__ float w_s[kTile], l_s[kTile], red_s[kWarps];
  float mx = kNegInf;
  for (int s = threadIdx.x; s < n_live; s += kThreads)
    mx = fmaxf(mx, ml[(row0 + s * stride) * 2]);
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = mx;
  __syncthreads();
  float M = red_s[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) M = fmaxf(M, red_s[i]);
  for (int d0 = 0; d0 < sh.hd; d0 += kThreads) {
    const int d = d0 + threadIdx.x;
    float L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += kTile) {
      const int n = min(kTile, n_live - s0);
      __syncthreads();  // every thread is done with the previous tile
      for (int t = threadIdx.x; t < n; t += kThreads) {
        const size_t row = row0 + (s0 + t) * stride;
        w_s[t] = expf(ml[row * 2] - M);
        l_s[t] = ml[row * 2 + 1];
      }
      __syncthreads();
      for (int t = 0; t < n; ++t) L = fmaf(l_s[t], w_s[t], L);
      if (d < sh.hd) {
#pragma unroll 8
        for (int t = 0; t < n; ++t)
          A = fmaf(a.part[(row0 + (s0 + t) * stride) * sh.hd + d], w_s[t],
                   A);
      }
    }
    if (d < sh.hd)
      static_cast<QT*>(a.out)[((size_t)b * sh.H + h) * sh.hd + d] =
          from_f32<QT>(A / fmaxf(L, 1e-30f));
  }
}

// Shared memory of a split CTA; the wrapper's split_plan mirrors it.
int smem_bytes(const Shape& sh, int GT, bool wide) {
  const int head = kCbBytes + round16(4 * sh.pps);  // codebooks, block ids
  const int ring = sh.stages * sh.stage_bytes + kSlack;
  if (wide)
    return head + round16(4 * sh.hd) + 4 * kWarps * sh.hd +
           round16(kWarps * 2 * 4) + ring;
  const int red = 4 * kWarps * GT * (sh.hd + 2);
  return head + (ring > red ? ring : red);
}

template <auto Kern>
int launch_split(dim3 grid, int smem, const Args& a, const Shape& sh,
                 cudaStream_t stream) {
  // raise this kernel's dynamic shared-memory limit only when a call needs
  // more than any before it (so later launches, inside a CUDA graph
  // capture too, make no other runtime call)
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  Kern<<<grid, kThreads, smem, stream>>>(a, sh);
  return (int)cudaGetLastError();
}

template <int FMT, typename QT>
int launch(const Args& a, const Shape& sh, cudaStream_t stream) {
  const int GT = (int)a.heads_per_cta;
  const int dpl = (int)a.dims_per_lane;
  const bool wide = dpl == 0;
  if (wide ? GT != 1 : (GT != 1 && GT != 2 && GT != 4 && GT != 8) ||
                           sh.G % GT)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(sh, GT, wide);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(sh.n_splits, sh.KV * (sh.G / GT), sh.B);
  int rc;
#define PA_SPLIT(G_, D_)                                                    \
  if (GT == G_ && dpl == D_)                                                \
    rc = launch_split<&paged_split_kernel<FMT, QT, G_, D_>>(grid, smem, a,  \
                                                            sh, stream);
  if (wide) {
    rc = launch_split<&paged_split_wide_kernel<FMT, QT>>(grid, smem, a, sh,
                                                         stream);
  } else {
    rc = (int)cudaErrorInvalidValue;
    PA_SPLIT(1, 4) PA_SPLIT(2, 4) PA_SPLIT(4, 4) PA_SPLIT(8, 4)
    PA_SPLIT(1, 8) PA_SPLIT(2, 8) PA_SPLIT(4, 8) PA_SPLIT(8, 8)
  }
#undef PA_SPLIT
  if (rc != 0 || sh.n_splits == 1) return rc;
  paged_combine_kernel<QT><<<dim3(sh.H, sh.B), kThreads, 0, stream>>>(a, sh);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch(const Args& a, const Shape& sh, cudaStream_t stream) {
  switch (a.fmt) {
    case kF32: return launch<kF32, QT>(a, sh, stream);
    case kBF16: return launch<kBF16, QT>(a, sh, stream);
    case kInt8: return launch<kInt8, QT>(a, sh, stream);
    case kInt4: return launch<kInt4, QT>(a, sh, stream);
    case kVq2: return launch<kVq2, QT>(a, sh, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every argument in one int64 array, in the order of struct Args: q,
// q_is_bf16 (0: q and out f32, 1: bf16), k_pool, v_pool, k_scale, v_scale
// (null for f32/bf16 pages), k_cb, v_cb (null unless vq2), page_table, pos,
// out, part (the splits' scratch, null with one split), B, H, KV, hd,
// row_bytes, page_size, n_pages, num_blocks, fmt (0 f32, 1 bf16, 2 int8,
// 3 int4, 4 vq2), then the split plan (pages_per_split, n_splits, stages,
// heads_per_cta, dims_per_lane: 4 or 8, 0 for the wide variant,
// lanes_per_row), the copy width (cp_bytes 16/8/4, 0 for plain loads) and
// copy_lanes (lanes a row, a power of two <= 32), and the stream. Launches
// the split kernel and, with more than one split, the merge; returns
// cudaGetLastError() after the last launch, or the error that refused one.
extern "C" int paged_attention_launch(const long long* raw) {
  Args a;
  __builtin_memcpy(&a, raw, sizeof(Args));
  const int lpr = (int)a.lanes_per_row, cpl = (int)a.copy_lanes;
  if (a.KV < 1 || a.H % a.KV != 0 || a.page_size < 1 || a.n_pages < 1 ||
      a.num_blocks < 1 || a.hd < 1 || a.pages_per_split < 1 ||
      a.n_splits != (a.n_pages + a.pages_per_split - 1) / a.pages_per_split ||
      (a.n_splits > 1 && a.part == nullptr) || a.stages < 1 ||
      a.stages > 2 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) ||
      cpl < 1 || cpl > 32 || (cpl & (cpl - 1)) ||
      (a.cp_bytes != 0 && a.cp_bytes != 4 && a.cp_bytes != 8 &&
       a.cp_bytes != 16))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.B = (int)a.B;
  sh.H = (int)a.H;
  sh.KV = (int)a.KV;
  sh.G = (int)(a.H / a.KV);
  sh.hd = (int)a.hd;
  sh.row_bytes = (int)a.row_bytes;
  sh.rs = round16(sh.row_bytes);
  sh.ps = (int)a.page_size;
  sh.n_pages = (int)a.n_pages;
  sh.num_blocks = (int)a.num_blocks;
  sh.pps = (int)a.pages_per_split;
  sh.n_splits = (int)a.n_splits;
  sh.stages = (int)a.stages;
  sh.stage_bytes = stage_bytes(sh.ps, sh.row_bytes, a.fmt >= kInt8);
  sh.lpr = lpr;
  sh.cp = (int)a.cp_bytes;
  sh.cpl = cpl;
  sh.sm_scale = 1.0f / sqrtf((float)sh.hd);
  if (sh.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)a.stream;
  if (a.q_bf16) return dispatch<__nv_bfloat16>(a, sh, s);
  return dispatch<float>(a, sh, s);
}
