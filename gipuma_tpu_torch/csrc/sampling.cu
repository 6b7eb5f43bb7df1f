// Bilinear sampler for Hopper (sm_90a).
//
// Replaces gipuma_tpu/ops/pallas_sampling.py::_sample_kernel (and the XLA
// gather of ops/sampling.bilinear_sample_packed, which computes the same
// function): the exact cost path's read of every source view at the warped
// window positions.
//
//   x  = clip(x, 0, W-1),  x0 = clip(floor(x), 0, W-2),  fx = clip(x-x0, 0, 1)
//   (same for y)
//   out[b, c, n] = (v00*(1-fx) + v01*fx)*(1-fy) + (v10*(1-fx) + v11*fx)*fy
//
// for src [C, H, W] f32 and coordinates x, y [B, N] f32 -> out [B, C, N].
// The clips pass NaN through, as jnp.clip does (fminf/fmaxf would drop it
// and turn a degenerate plane's NaN cost into a finite one).  Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn, and the build's
// -fmad=false), so the kernel is bit-equal to the plain torch version.
//
// Bound: bytes.  Per sample 8 B of coordinates in and 4*C B out; the four
// taps per channel come from the source, which is a few MB per view and
// stays in the 50 MB L2 across a launch (warped windows are spatially
// coherent).  Design: one thread per sample, looping over the C channels,
// so the coordinates and the clip/floor arithmetic are done once per
// sample; neighbouring threads take neighbouring samples, so coordinate
// reads and output writes coalesce.  The TPU kernel's 128-column block
// split, 8-row tile spans and VMEM dynamic_gather exist for the TPU's
// lack of a general gather and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// clip that propagates NaN (comparisons with NaN are false).
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void bilinear_sample_kernel(const float* __restrict__ src,
                                       const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       float* __restrict__ out, int C, int H,
                                       int W, long long N, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / N;
  const long long n = i - b * N;
  const float xx = clip_nan(__ldg(x + i), 0.0f, (float)(W - 1));
  const float yy = clip_nan(__ldg(y + i), 0.0f, (float)(H - 1));
  // (int)NaN is 0 on the device; the integer clamp keeps every tap in range.
  const int x0 = min(max((int)floorf(xx), 0), W - 2);
  const int y0 = min(max((int)floorf(yy), 0), H - 2);
  const float fx = clip_nan(__fsub_rn(xx, (float)x0), 0.0f, 1.0f);
  const float fy = clip_nan(__fsub_rn(yy, (float)y0), 0.0f, 1.0f);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const size_t plane = (size_t)H * W;
  const float* s = src + (size_t)y0 * W + x0;
  float* o = out + (size_t)b * C * N + n;
  for (int c = 0; c < C; ++c) {
    const float* p = s + c * plane;
    const float v00 = __ldg(p), v01 = __ldg(p + 1);
    const float v10 = __ldg(p + W), v11 = __ldg(p + W + 1);
    const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
    const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
    o[(size_t)c * N] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  }
}

}  // namespace

extern "C" int gtt_bilinear_sample(const void* src, const void* x,
                                   const void* y, void* out, int C, int H,
                                   int W, long long N, long long B,
                                   void* stream) {
  const long long total = N * B;
  if (total <= 0 || C <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  bilinear_sample_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)src, (const float*)x, (const float*)y, (float*)out, C, H,
      W, N, total);
  return (int)cudaGetLastError();
}
