// The exact PM cost's window epilogue for Hopper (sm_90a): samples ->
// bilaterally weighted, truncated window sum -> per-view cost, in one
// launch.
//
// Replaces the torch expression that follows the sampler on the exact cost
// path (gipuma_tpu_torch/ops/cost.py, pm_window_cost_plain: about 25
// launches over [K, O, H, W2] planes) and computes what the JAX package's
// offset scan computes (gipuma_tpu/ops/cost.py, per_view_costs, its PM
// step).  For each candidate k and active pixel (i, j) of source view v:
//
//   acc = 0
//   for each window offset (dx, dy), dx-even offsets first, in list order:
//     w    = exp(-mean_c |ref(dx, dy) - ref(0, 0)| * (1 / gamma))
//     col  = min(mean_c |ref(dx, dy) - s_img|, tau_color)
//     grad = min((mean_c |gx(dx, dy) - s_gx| + mean_c |gy(dx, dy) - s_gy|)
//                * 0.0625, tau_gradient)
//     acc  = acc + w * ((1 - alpha) * col + alpha * grad)
//   out[k, i, j] = (acc is NaN or acc >= MAXCOST or view_valid[v] == 0)
//                  ? MAXCOST : acc
//
// ref, gx, gy: the reference's edge-padded even/odd column planes
// (ops/checkerboard.PaddedEO, stacked [2, Hp, Wp2, C]) read at row
// pr + i + dy and column x + dx + pc of the active pixel x = 2j + (i +
// parity) % 2; s_img, s_gx, s_gy: the sampler's output [kc*O, 3C, H, W2] at
// (k, o), o the offset's place in the sampled list.  The truncations pass
// NaN through (v > tau ? tau : v, as torch.clamp does; fminf would turn a
// degenerate plane's NaN into tau and so into a finite cost).  Each product
// and sum is rounded on its own (the build's -fmad=false) in the plain
// version's order within a term, so the only difference from the plain
// version is the order of the sum over offsets.
//
// Bound: bytes.  Per output 4*3C*O B of samples in and 4 B out; the
// reference planes (a few MB) stay in L1/L2 and view_valid and the offset
// table are read by every thread at one address.  Design: one thread per
// (k, i, j), neighbouring j in neighbouring threads, so each sample read of
// a warp is one coalesced line and an offset's reference reads of a warp
// fall in one row.  The offset loop is compiled for the presets' windows
// (O = 36: box 11, O = 64: box 15, increment 2, C = 1) and once for any
// other (O, C).
#include <cuda_runtime.h>

namespace {

// min(v, tau) that passes NaN through.
__device__ __forceinline__ float trunc_nan(float v, float tau) {
  return v > tau ? tau : v;
}

struct Shape {
  int kc, O, C, H, W2, Hp, Wp2, pr, pc, parity, v;
  float one_minus_alpha, alpha, inv_gamma, tau_color, tau_gradient, maxcost;
};

// table: [O, 3] int32 (dx, dy, o) in summation order.
template <int kO, int kC>
__global__ void __launch_bounds__(256) exact_window_cost_kernel(
    const float* __restrict__ smp, const float* __restrict__ ref,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const int* __restrict__ table, const float* __restrict__ view_valid,
    float* __restrict__ out, const Shape p) {
  const int O = kO > 0 ? kO : p.O;
  const int C = kC > 0 ? kC : p.C;
  const long long N = (long long)p.H * p.W2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.kc * N) return;
  const long long k = idx / N;
  const long long n = idx - k * N;
  const int i = (int)(n / p.W2);
  const int j = (int)(n - (long long)i * p.W2);
  const int pi = (i + p.parity) & 1;
  const size_t eo_plane = (size_t)p.Hp * p.Wp2 * C;
  const int s0 = pi + p.pc;
  const size_t a0 = (size_t)(s0 & 1) * eo_plane +
                    ((size_t)(p.pr + i) * p.Wp2 + (s0 >> 1) + j) * C;
  float ctr[kC > 0 ? kC : 1];
  if (kC > 0) {
#pragma unroll
    for (int c = 0; c < (kC > 0 ? kC : 1); ++c) ctr[c] = __ldg(ref + a0 + c);
  }
  const float* sk = smp + (size_t)k * O * 3 * C * N + n;
  float acc = 0.0f;
#pragma unroll 4
  for (int t = 0; t < O; ++t) {
    const int dx = __ldg(table + 3 * t);
    const int dy = __ldg(table + 3 * t + 1);
    const int o = __ldg(table + 3 * t + 2);
    const int s = pi + dx + p.pc;
    const size_t a = (size_t)(s & 1) * eo_plane +
                     ((size_t)(p.pr + i + dy) * p.Wp2 + (s >> 1) + j) * C;
    const float* so = sk + (size_t)o * 3 * C * N;
    float dw = 0.0f, dc = 0.0f, dgx = 0.0f, dgy = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float r = __ldg(ref + a + c);
      const float rc = kC > 0 ? ctr[kC > 0 ? c : 0] : __ldg(ref + a0 + c);
      dw = __fadd_rn(dw, fabsf(__fsub_rn(r, rc)));
      dc = __fadd_rn(dc, fabsf(__fsub_rn(r, __ldg(so + (size_t)c * N))));
      dgx = __fadd_rn(dgx, fabsf(__fsub_rn(__ldg(gx + a + c),
                                           __ldg(so + (size_t)(C + c) * N))));
      dgy = __fadd_rn(dgy,
                      fabsf(__fsub_rn(__ldg(gy + a + c),
                                      __ldg(so + (size_t)(2 * C + c) * N))));
    }
    if (C > 1) {
      const float fc = (float)C;
      dw = __fdiv_rn(dw, fc);
      dc = __fdiv_rn(dc, fc);
      dgx = __fdiv_rn(dgx, fc);
      dgy = __fdiv_rn(dgy, fc);
    }
    const float w = expf(__fmul_rn(-dw, p.inv_gamma));
    const float col = trunc_nan(dc, p.tau_color);
    const float grad = trunc_nan(__fmul_rn(__fadd_rn(dgx, dgy), 0.0625f),
                                 p.tau_gradient);
    acc = __fadd_rn(acc, __fmul_rn(w, __fadd_rn(
                                          __fmul_rn(p.one_minus_alpha, col),
                                          __fmul_rn(p.alpha, grad))));
  }
  const float valid = __ldg(view_valid + p.v);
  out[idx] = (isnan(acc) || acc >= p.maxcost || valid == 0.0f) ? p.maxcost
                                                                : acc;
}

template <int kO, int kC>
int launch(const void* smp, const void* ref, const void* gx, const void* gy,
           const void* table, const void* view_valid, void* out,
           const Shape& p, long long blocks, cudaStream_t stream) {
  exact_window_cost_kernel<kO, kC><<<(unsigned)blocks, 256, 0, stream>>>(
      (const float*)smp, (const float*)ref, (const float*)gx,
      (const float*)gy, (const int*)table, (const float*)view_valid,
      (float*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gtt_exact_window_cost(
    const void* smp, const void* ref, const void* gx, const void* gy,
    const void* table, const void* view_valid, void* out, int kc, int O,
    int C, int H, int W2, int Hp, int Wp2, int pr, int pc, int parity, int v,
    float one_minus_alpha, float alpha, float inv_gamma, float tau_color,
    float tau_gradient, float maxcost, void* stream) {
  const long long total = (long long)kc * H * W2;
  if (total <= 0 || O <= 0 || C <= 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const Shape p{kc, O, C, H, W2, Hp, Wp2, pr, pc, parity, v,
                one_minus_alpha, alpha, inv_gamma, tau_color, tau_gradient,
                maxcost};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1 && O == 36)
    return launch<36, 1>(smp, ref, gx, gy, table, view_valid, out, p, blocks,
                         s);
  if (C == 1 && O == 64)
    return launch<64, 1>(smp, ref, gx, gy, table, view_valid, out, p, blocks,
                         s);
  return launch<0, 0>(smp, ref, gx, gy, table, view_valid, out, p, blocks, s);
}
