// Hessian-weighted nearest-centroid assignment (GPTVQ Eq. 4), batched over
// row bands, for sm_90a.
//
// Replaces: src/repro/kernels/vq_assign.py::vq_assign (Pallas TPU kernel,
// body `_kernel`). The reference kernel is the single-band case; the
// quantizer vmaps `core/codebook.assign` over row bands with one codebook
// per band, so this kernel takes the band axis directly:
//   x (B, n, d) f32, hw (B, n, d) f32 or one (n, d) plane shared by all
//   bands (hw_batch_stride = 0), codebooks (B, k, d) f32  ->  out (B, n) i32
//   out[b, i] = argmin_m sum_p hw[b,i,p] * (x[b,i,p] - C[b,m,p])^2,
// ties to the lowest index (strict <), the explicit form of
// kernels/ref.py::vq_assign_ref.
//
// What bounds it on the H100: at the quantizer's shapes (k = 16, d = 2,
// n = 512 rows per band in EM init, n = 4 in the span sweep) the work is
// a few hundred KB and a few MFLOP per call, far below a microsecond of
// memory or FP32 time: the launch itself bounds it.
//
// Design: one CTA covers `bands_per_cta` bands x `rows_per_cta` rows. The
// CTA stages its bands' k*d codebooks in shared memory (<= 48 KB, chosen by
// the wrapper), and each thread scores one row against all k centroids
// from registers. Small-n calls (the sweep) pack many bands into a CTA so
// that threads are not left idle; the TPU version's expanded-form MXU
// matmuls are not needed at d <= 4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 4;

__global__ void vq_assign_kernel(const float* __restrict__ x,
                                 const float* __restrict__ hw,
                                 const float* __restrict__ cb,
                                 int32_t* __restrict__ out, int B, int n,
                                 int d, int k, long long hw_batch_stride,
                                 int bands_per_cta, int rows_per_cta) {
  extern __shared__ float cb_s[];
  const int band0 = blockIdx.x * bands_per_cta;
  const int nb = min(bands_per_cta, B - band0);
  const int kd = k * d;
  const float* cb_src = cb + (long long)band0 * kd;
  for (int i = threadIdx.x; i < nb * kd; i += blockDim.x) cb_s[i] = cb_src[i];
  __syncthreads();

  const int t = threadIdx.x;
  const int lb = t / rows_per_cta;
  const int row = blockIdx.y * rows_per_cta + t % rows_per_cta;
  if (lb >= nb || row >= n) return;
  const int b = band0 + lb;

  const float* xr = x + ((long long)b * n + row) * d;
  const float* hr = hw + (long long)b * hw_batch_stride + (long long)row * d;
  float xv[kMaxD], hv[kMaxD];
#pragma unroll
  for (int p = 0; p < kMaxD; ++p) {
    xv[p] = p < d ? xr[p] : 0.f;
    hv[p] = p < d ? hr[p] : 0.f;
  }
  const float* c = cb_s + lb * kd;
  float best = INFINITY;
  int best_i = 0;
  for (int m = 0; m < k; ++m) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxD; ++p) {
      if (p < d) {
        const float df = xv[p] - c[m * d + p];
        s += hv[p] * df * df;
      }
    }
    if (s < best) {
      best = s;
      best_i = m;
    }
  }
  out[(long long)b * n + row] = best_i;
}

}  // namespace

extern "C" int vq_assign_launch(const float* x, const float* hw,
                                const float* cb, int32_t* out, int B, int n,
                                int d, int k, long long hw_batch_stride,
                                int bands_per_cta, int rows_per_cta,
                                int threads, void* stream) {
  if (d < 1 || d > kMaxD || bands_per_cta * rows_per_cta > threads)
    return (int)cudaErrorInvalidValue;
  dim3 grid((B + bands_per_cta - 1) / bands_per_cta,
            (n + rows_per_cta - 1) / rows_per_cta);
  const size_t smem = (size_t)bands_per_cta * k * d * sizeof(float);
  vq_assign_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, hw, cb, out, B, n, d, k, hw_batch_stride, bands_per_cta,
      rows_per_cta);
  return (int)cudaGetLastError();
}
