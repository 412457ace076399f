// Hessian-weighted nearest-centroid assignment (GPTVQ Eq. 4) for sm_90a,
// and the two loops of the quantizer that run it: a column group's d-span
// sweep with error feedback, and the EM codebook fit. One __device__
// argmin (weighted_argmin) serves all three entry points.
//
// Replaces: src/repro/kernels/vq_assign.py::vq_assign (Pallas TPU kernel,
// body `_kernel`). The reference kernel is the single-band case; the
// quantizer vmaps `core/codebook.assign` over row bands with one codebook
// per band, so vq_assign_kernel takes the band axis directly:
//   x (B, n, d) f32, hw (B, n, d) f32 or one (n, d) plane shared by all
//   bands (hw_batch_stride = 0), codebooks (B, k, d) f32  ->  out (B, n) i32
//   out[b, i] = argmin_m sum_p hw[b,i,p] * (x[b,i,p] - C[b,m,p])^2,
// ties to the lowest index (strict <), the explicit form of
// kernels/ref.py::vq_assign_ref. The reference runs its quantizer's loops
// around that function as `fori_loop`s (core/gptvq.py::_group_sweep's span
// loop, core/codebook.py::em); here each loop runs inside one launch:
//
//   vq_group_sweep_kernel: one column group's sweep. Rows are independent
//     (a row's error feeds only that row's later columns), so a CTA takes
//     `rows` rows and walks the group's d-spans in order: at span j the
//     first `rows` threads assign their row's span (weighted_argmin on the
//     band's codebook), write q = C[idx] * S and the compensated error
//     Et = (x - q) U_PP^{-1} (forward substitution, or / diag(U) without
//     exact_span_solve); then every thread takes columns > the span and
//     subtracts Et . U[span, c] from each row. The CTA's rows of W sit in
//     shared memory for the whole sweep (global memory where a row is too
//     wide), the bands' codebooks too; U's rows are read from L2, the next
//     one fetched while the span is assigned. Two barriers a span.
//     Metric mode (the `babai` solver, core/solvers.py; the reference's
//     `solver == "babai" and d > 1` branch of _group_sweep): with `metric`
//     set, span j's argmin minimises y^T M_j y, y = (x/S - c) * S, over the
//     span's d x d conditional metric M_j = (U_PP^T U_PP)^{-1}. The metrics
//     of all of a group's spans are formed before the launch, in one
//     batched triangular solve (kernels/vq_assign.py::span_metrics), and
//     passed as a (spans, D, D) tensor; the assigning thread fetches M_j a
//     span ahead with the other span operands (at most 16 floats). Without
//     it the diagonal weighted_argmin runs, unchanged.
//   vq_em_kernel: `iters` E/M steps of one band a CTA, the codebook in
//     shared memory throughout. E-step: weighted_argmin per point into an
//     index array (shared memory, global scratch for very long bands).
//     M-step: a warp per centroid sums hw*x and hw over the points assigned
//     to it in a fixed lane order and a fixed shuffle tree (no atomics, so
//     a codebook is the same bits from call to call); a centroid whose
//     weight sum is <= 1e-12 keeps its value, as core/codebook.m_step.
//
// What bounds it on the H100, each of the three: at the quantizer's shapes
// (k = 16, d = 2; a 4096 x 256 group, bands of 512 points) a launch moves a
// few MB and does a few hundred MFLOP, microseconds of bytes or FP32 time;
// vq_assign alone is bound by its launch. The sweep's
// 128 dependent spans (two barriers and an argmin's latency each) and EM's
// 25 dependent steps set the time instead: the design keeps every span and
// step inside one launch, so the host launches once a group, not ~10 ops a
// span.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the shared memory a sweep or EM CTA may take (of the 227 KB an SM offers)
constexpr size_t kSmemBudget = 200 * 1024;

// Eq. 4 for one point: argmin_m sum_p hv[p] * (xv[p] - c[m, p])^2 over the
// k centroids at c (k x D, row-major), ties to the lowest index (strict <).
// Each term is rounded as the plain PyTorch version rounds it, (hv*df)*df,
// and the terms are added left to right with no FMA contraction, so at
// d <= 2 the distances are the plain version's bits.
template <int D>
__device__ __forceinline__ int weighted_argmin(const float (&xv)[D],
                                               const float (&hv)[D],
                                               const float* c, int k) {
  float best = INFINITY;
  int best_i = 0;
#pragma unroll 4
  for (int m = 0; m < k; ++m) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < D; ++p) {
      const float df = __fsub_rn(xv[p], c[m * D + p]);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(hv[p], df), df));
    }
    if (s < best) {
      best = s;
      best_i = m;
    }
  }
  return best_i;
}

// The babai span metric for one point: argmin_m y^T M y with
// y[p] = (xv[p] - c[m, p]) * sv[p], ties to the lowest index. Each term is
// rounded as the plain version writes it: y, then (y M)[p] summed over e in
// order, then sum_p y[p] * (y M)[p] left to right, no FMA contraction.
template <int D>
__device__ __forceinline__ int metric_argmin(const float (&xv)[D],
                                             const float (&sv)[D],
                                             const float (&mv)[D][D],
                                             const float* c, int k) {
  float best = INFINITY;
  int best_i = 0;
#pragma unroll 2
  for (int m = 0; m < k; ++m) {
    float y[D];
#pragma unroll
    for (int p = 0; p < D; ++p)
      y[p] = __fmul_rn(__fsub_rn(xv[p], c[m * D + p]), sv[p]);
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < D; ++p) {
      float ym = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) ym = __fadd_rn(ym, __fmul_rn(y[e], mv[e][p]));
      s = __fadd_rn(s, __fmul_rn(y[p], ym));
    }
    if (s < best) {
      best = s;
      best_i = m;
    }
  }
  return best_i;
}

// ---------------------------------------------------------------------------
// vq_assign: one thread a row; one CTA covers `bands_per_cta` bands x
// `rows_per_cta` rows, the bands' codebooks staged in shared memory (small-n
// calls pack many bands into a CTA so that threads are not left idle).
// ---------------------------------------------------------------------------

template <int D>
__global__ void vq_assign_kernel(const float* __restrict__ x,
                                 const float* __restrict__ hw,
                                 const float* __restrict__ cb,
                                 int32_t* __restrict__ out, int B, int n,
                                 int k, long long hw_batch_stride,
                                 int bands_per_cta, int rows_per_cta) {
  extern __shared__ float cb_s[];
  const int band0 = blockIdx.x * bands_per_cta;
  const int nb = min(bands_per_cta, B - band0);
  const int kd = k * D;
  const float* cb_src = cb + (long long)band0 * kd;
  for (int i = threadIdx.x; i < nb * kd; i += blockDim.x) cb_s[i] = cb_src[i];
  __syncthreads();

  const int t = threadIdx.x;
  const int lb = t / rows_per_cta;
  const int row = blockIdx.y * rows_per_cta + t % rows_per_cta;
  if (lb >= nb || row >= n) return;
  const int b = band0 + lb;

  const float* xr = x + ((long long)b * n + row) * D;
  const float* hr = hw + (long long)b * hw_batch_stride + (long long)row * D;
  float xv[D], hv[D];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    xv[p] = xr[p];
    hv[p] = hr[p];
  }
  out[(long long)b * n + row] = weighted_argmin<D>(xv, hv, cb_s + lb * kd, k);
}

template <int D>
int launch_assign(const float* x, const float* hw, const float* cb,
                  int32_t* out, int B, int n, int k, long long hw_stride,
                  int bands_per_cta, int rows_per_cta, int threads,
                  cudaStream_t stream) {
  dim3 grid((B + bands_per_cta - 1) / bands_per_cta,
            (n + rows_per_cta - 1) / rows_per_cta);
  const size_t smem = (size_t)bands_per_cta * k * D * sizeof(float);
  vq_assign_kernel<D><<<grid, threads, smem, stream>>>(
      x, hw, cb, out, B, n, k, hw_stride, bands_per_cta, rows_per_cta);
  return (int)cudaGetLastError();
}

// Opt a kernel in to `smem` bytes of dynamic shared memory above 48 KB, once
// per kernel and size (the call is host work; under stream capture too).
template <typename Kern>
int allow_smem(Kern kern, size_t smem, size_t* allowed) {
  if (smem <= 48 * 1024 || smem <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *allowed = smem;
  return 0;
}

// ---------------------------------------------------------------------------
// vq_group_sweep
// ---------------------------------------------------------------------------

struct SweepArgs {
  float* w;            // (r, cg) the group's weights, row stride ldw; in place
  const float* u;      // (cg, cg) the group's block of U, row stride ldu
  const float* s;      // (r, cg) normalization scales, row stride lds
  const float* cb;     // (n_bands, k, D) codebooks
  const float* wgt;    // (cg,) Hessian weights 1 / U_qq^2
  const float* metric; // (cg / D, D, D) span metrics (babai), or null
  float* q;            // (r, cg) out: S * C[idx]
  float* e;            // (r, cg) out: compensated errors Et
  int32_t* idx;        // (r, cg / D) out
  long long ldw, ldu, lds;
  int r, cg, k, rpb, exact, rows;
  int w_in_smem, cb_in_smem;
};

// bands a CTA of `rows` rows can touch, for bands of `rpb` rows
inline int sweep_bands(int rows, int rpb) {
  return (rows - 1 + rpb - 1) / rpb + 1;
}

template <int D>
__global__ void vq_group_sweep_kernel(SweepArgs a) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * a.rows;
  const int nr = min(a.rows, a.r - row0);
  const int band0 = row0 / a.rpb;
  const int kd = a.k * D;
  const int cg = a.cg;
  const long long ldu = a.ldu;

  // shared memory: this span's Et of each row (rows x D), then the rows'
  // tile of W and the bands' codebooks, each with an odd stride so that the
  // assigning threads (a row each) read distinct banks
  float* es = sm;
  float* rest = sm + a.rows * D;
  float* wt;
  long long ldt;
  if (a.w_in_smem) {
    wt = rest;
    ldt = cg + 1;
    rest += (size_t)a.rows * ldt;
    for (int i = t; i < nr * cg; i += blockDim.x) {
      const int rr = i / cg, c = i - rr * cg;
      wt[rr * ldt + c] = a.w[(row0 + rr) * a.ldw + c];
    }
  } else {
    wt = a.w + row0 * a.ldw;
    ldt = a.ldw;
  }
  const float* cbs = a.cb + (long long)band0 * kd;
  int ldc = kd;
  if (a.cb_in_smem) {
    const int nb = (row0 + nr - 1) / a.rpb - band0 + 1;
    ldc = kd + 1;
    for (int i = t; i < nb * kd; i += blockDim.x) {
      const int lb = i / kd;
      rest[lb * ldc + (i - lb * kd)] = cbs[i];
    }
    cbs = rest;
  }
  __syncthreads();

  // the span's row-independent operands, fetched one span ahead by the
  // assigning threads: Hessian weights, U_PP's upper triangle, this row's
  // scales
  const int row = row0 + t;
  const bool assigns = t < nr;
  const float* crow = cbs + (long long)(row / a.rpb - band0) * ldc;
  float hv[D], upp[D][D], sv[D], mv[D][D];
  auto fetch = [&](int col) {
#pragma unroll
    for (int p = 0; p < D; ++p) {
      hv[p] = __ldg(a.wgt + col + p);
      sv[p] = __ldg(a.s + row * a.lds + col + p);
#pragma unroll
      for (int q2 = 0; q2 <= p; ++q2)
        upp[q2][p] = __ldg(a.u + (col + q2) * ldu + col + p);
    }
    if (a.metric) {
      const float* mp = a.metric + (long long)col * D;  // span col / D
#pragma unroll
      for (int p = 0; p < D; ++p)
#pragma unroll
        for (int e = 0; e < D; ++e) mv[p][e] = __ldg(mp + p * D + e);
    }
  };
  if (assigns) fetch(0);

  const int spans = cg / D;
  for (int j = 0; j < spans; ++j) {
    const int col = j * D;
    // U's rows of this span at this thread's first column past it
    const int c0 = col + D + t;
    float u0[D];
    if (c0 < cg) {
#pragma unroll
      for (int p = 0; p < D; ++p) u0[p] = __ldg(a.u + (col + p) * ldu + c0);
    }
    if (assigns) {
      float x[D], xn[D], et[D];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        x[p] = wt[t * ldt + col + p];
        xn[p] = x[p] / sv[p];
      }
      const int m = a.metric ? metric_argmin<D>(xn, sv, mv, crow, a.k)
                             : weighted_argmin<D>(xn, hv, crow, a.k);
      float* qr = a.q + (long long)row * cg + col;
      float* er = a.e + (long long)row * cg + col;
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const float qv = crow[m * D + p] * sv[p];
        float v = x[p] - qv;
        if (a.exact) {
#pragma unroll
          for (int q2 = 0; q2 < p; ++q2) v -= et[q2] * upp[q2][p];
        }
        et[p] = v / upp[p][p];
        qr[p] = qv;
        er[p] = et[p];
        es[t * D + p] = et[p];
      }
      a.idx[(long long)row * spans + j] = m;
      if (j + 1 < spans) fetch(col + D);
    }
    __syncthreads();
    for (int c = c0; c < cg; c += blockDim.x) {
      float uv[D];
#pragma unroll
      for (int p = 0; p < D; ++p)
        uv[p] = c == c0 ? u0[p] : __ldg(a.u + (col + p) * ldu + c);
      for (int rr = 0; rr < nr; ++rr) {
        float acc = es[rr * D] * uv[0];
#pragma unroll
        for (int p = 1; p < D; ++p) acc = fmaf(es[rr * D + p], uv[p], acc);
        wt[rr * ldt + c] -= acc;
      }
    }
    __syncthreads();
  }
  if (a.w_in_smem) {
    for (int i = t; i < nr * cg; i += blockDim.x) {
      const int rr = i / cg, c = i - rr * cg;
      a.w[(row0 + rr) * a.ldw + c] = wt[rr * ldt + c];
    }
  }
}

template <int D>
int launch_sweep(SweepArgs a, int threads, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t es = (size_t)a.rows * D;
  const size_t tile = (size_t)a.rows * (a.cg + 1);
  const size_t cbs = (size_t)sweep_bands(a.rows, a.rpb) * (a.k * D + 1);
  a.w_in_smem = (es + tile) * sizeof(float) <= kSmemBudget;
  a.cb_in_smem = (es + (a.w_in_smem ? tile : 0) + cbs) * sizeof(float) <=
                 kSmemBudget;
  const size_t smem = (es + (a.w_in_smem ? tile : 0) +
                       (a.cb_in_smem ? cbs : 0)) * sizeof(float);
  if (int rc = allow_smem(vq_group_sweep_kernel<D>, smem, &allowed)) return rc;
  const int grid = (a.r + a.rows - 1) / a.rows;
  vq_group_sweep_kernel<D><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// vq_em
// ---------------------------------------------------------------------------

struct EmArgs {
  const float* x;      // (B, n, D)
  const float* hw;     // (B, n, D), or (n, D) with hw_stride 0
  const float* c0;     // (B, k, D) seeds
  float* c;            // (B, k, D) out
  int32_t* idx_g;      // (B, n) scratch where the indices leave shared memory
  long long hw_stride;
  int n, k, iters, idx_in_smem;
};

template <int D>
__global__ void vq_em_kernel(EmArgs a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int kd = a.k * D;
  float* cs = sm;
  int32_t* idx = a.idx_in_smem ? reinterpret_cast<int32_t*>(sm + kd)
                               : a.idx_g + (long long)b * a.n;
  const float* x = a.x + (long long)b * a.n * D;
  const float* hw = a.hw + (long long)b * a.hw_stride;
  for (int i = t; i < kd; i += blockDim.x) cs[i] = a.c0[(long long)b * kd + i];
  __syncthreads();
  const int lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
  for (int it = 0; it < a.iters; ++it) {
    for (int i = t; i < a.n; i += blockDim.x) {
      float xv[D], hv[D];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        xv[p] = __ldg(x + (long long)i * D + p);
        hv[p] = __ldg(hw + (long long)i * D + p);
      }
      idx[i] = weighted_argmin<D>(xv, hv, cs, a.k);
    }
    __syncthreads();
    for (int m = warp; m < a.k; m += n_warps) {
      float num[D], den[D];
#pragma unroll
      for (int p = 0; p < D; ++p) num[p] = den[p] = 0.f;
      for (int i = lane; i < a.n; i += 32) {
        if (idx[i] != m) continue;
#pragma unroll
        for (int p = 0; p < D; ++p) {
          const float h = __ldg(hw + (long long)i * D + p);
          num[p] = fmaf(h, __ldg(x + (long long)i * D + p), num[p]);
          den[p] += h;
        }
      }
      // a fixed butterfly: every lane ends with the same bits
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int p = 0; p < D; ++p) {
          num[p] += __shfl_xor_sync(0xffffffffu, num[p], off);
          den[p] += __shfl_xor_sync(0xffffffffu, den[p], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int p = 0; p < D; ++p)
          if (!(den[p] <= 1e-12f)) cs[m * D + p] = num[p] / den[p];
      }
    }
    __syncthreads();
  }
  for (int i = t; i < kd; i += blockDim.x) a.c[(long long)b * kd + i] = cs[i];
}

template <int D>
int launch_em(EmArgs a, int B, int threads, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t cb = (size_t)a.k * D * sizeof(float);
  a.idx_in_smem = cb + (size_t)a.n * sizeof(int32_t) <= kSmemBudget;
  if (!a.idx_in_smem && a.idx_g == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = cb + (a.idx_in_smem ? (size_t)a.n * sizeof(int32_t) : 0);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  if (int rc = allow_smem(vq_em_kernel<D>, smem, &allowed)) return rc;
  vq_em_kernel<D><<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vq_assign_launch(const float* x, const float* hw,
                                const float* cb, int32_t* out, int B, int n,
                                int d, int k, long long hw_batch_stride,
                                int bands_per_cta, int rows_per_cta,
                                int threads, void* stream) {
  if (bands_per_cta * rows_per_cta > threads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch_assign<1>(x, hw, cb, out, B, n, k, hw_batch_stride,
                                    bands_per_cta, rows_per_cta, threads, s);
    case 2: return launch_assign<2>(x, hw, cb, out, B, n, k, hw_batch_stride,
                                    bands_per_cta, rows_per_cta, threads, s);
    case 3: return launch_assign<3>(x, hw, cb, out, B, n, k, hw_batch_stride,
                                    bands_per_cta, rows_per_cta, threads, s);
    case 4: return launch_assign<4>(x, hw, cb, out, B, n, k, hw_batch_stride,
                                    bands_per_cta, rows_per_cta, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// vq_group_sweep_launch and vq_em_launch take every argument in one int64
// array, in these orders (kernels/vq_assign.py builds them)
enum SweepArg {
  kSwW, kSwLdw, kSwU, kSwLdu, kSwS, kSwLds, kSwCb, kSwWgt, kSwQ, kSwE,
  kSwIdx, kSwR, kSwCg, kSwD, kSwK, kSwRpb, kSwExact, kSwRows, kSwThreads,
  kSwMetric, kSwStream
};

extern "C" int vq_group_sweep_launch(const long long* p) {
  SweepArgs a{};
  a.w = reinterpret_cast<float*>(p[kSwW]);
  a.u = reinterpret_cast<const float*>(p[kSwU]);
  a.s = reinterpret_cast<const float*>(p[kSwS]);
  a.cb = reinterpret_cast<const float*>(p[kSwCb]);
  a.wgt = reinterpret_cast<const float*>(p[kSwWgt]);
  a.metric = reinterpret_cast<const float*>(p[kSwMetric]);
  a.q = reinterpret_cast<float*>(p[kSwQ]);
  a.e = reinterpret_cast<float*>(p[kSwE]);
  a.idx = reinterpret_cast<int32_t*>(p[kSwIdx]);
  a.ldw = p[kSwLdw];
  a.ldu = p[kSwLdu];
  a.lds = p[kSwLds];
  a.r = (int)p[kSwR];
  a.cg = (int)p[kSwCg];
  a.k = (int)p[kSwK];
  a.rpb = (int)p[kSwRpb];
  a.exact = (int)p[kSwExact];
  a.rows = (int)p[kSwRows];
  const int d = (int)p[kSwD], threads = (int)p[kSwThreads];
  if (a.r < 1 || a.cg < d || a.cg % d != 0 || a.k < 1 || a.rpb < 1 ||
      a.rows < 1 || a.rows > threads || threads % 32 != 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p[kSwStream]);
  switch (d) {
    case 1: return launch_sweep<1>(a, threads, s);
    case 2: return launch_sweep<2>(a, threads, s);
    case 3: return launch_sweep<3>(a, threads, s);
    case 4: return launch_sweep<4>(a, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

enum EmArg {
  kEmX, kEmHw, kEmHwStride, kEmC0, kEmC, kEmIdx, kEmB, kEmN, kEmD, kEmK,
  kEmIters, kEmThreads, kEmStream
};

extern "C" int vq_em_launch(const long long* p) {
  EmArgs a{};
  a.x = reinterpret_cast<const float*>(p[kEmX]);
  a.hw = reinterpret_cast<const float*>(p[kEmHw]);
  a.hw_stride = p[kEmHwStride];
  a.c0 = reinterpret_cast<const float*>(p[kEmC0]);
  a.c = reinterpret_cast<float*>(p[kEmC]);
  a.idx_g = reinterpret_cast<int32_t*>(p[kEmIdx]);
  a.n = (int)p[kEmN];
  a.k = (int)p[kEmK];
  a.iters = (int)p[kEmIters];
  const int B = (int)p[kEmB], d = (int)p[kEmD], threads = (int)p[kEmThreads];
  if (B < 1 || a.n < 1 || a.k < 1 || a.iters < 0 || threads % 32 != 0 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p[kEmStream]);
  switch (d) {
    case 1: return launch_em<1>(a, B, threads, s);
    case 2: return launch_em<2>(a, B, threads, s);
    case 3: return launch_em<3>(a, B, threads, s);
    case 4: return launch_em<4>(a, B, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
