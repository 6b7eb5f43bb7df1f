// The exact PM cost's two hand-written kernels for Hopper (sm_90a), one
// launch each per (source view, candidate chunk) on either side of the
// bilinear sampler (csrc/sampling.cu):
//
//   exact_warp_coords_kernel: plane terms -> the sampler's positions at
//     every window offset (the warp prologue);
//   exact_window_cost_kernel: the sampler's output -> bilaterally
//     weighted, truncated window sum -> per-view cost (the epilogue).
//
// Both are built without FMA contraction (-fmad=false) and round every
// product, sum and quotient on its own.
//
// ---- The warp prologue ----------------------------------------------------
//
// Replaces the torch expression that builds the sampler's positions
// (gipuma_tpu_torch/ops/cost.py, warped_coords and _center: 14 launches over
// [K, O, H, W2] planes and about a dozen smaller ones) and computes the
// position arithmetic of the JAX package's offset scan (gipuma_tpu/ops/
// cost.py:146-215, an XLA loop, no Pallas kernel).  The warp of pixel r + (dx,
// dy) under plane m = n / d is affine in the offset before
// dehomogenization.  For each candidate k, active pixel n = (i, j) and
// offset (dx, dy) of the sampled list (its order, o):
//
//   u_c  = ar[n, c] - b_c * mr[k, n]       A r - b (m . r)
//   ax_c = ac0[c]   - b_c * mc0[k, n]      A c0 - b (m . c0), c0 = K1inv[:, 0]
//   ay_c = ac1[c]   - b_c * mc1[k, n]      A c1 - b (m . c1), c1 = K1inv[:, 1]
//   p_c  = (u_c + dx * ax_c) + dy * ay_c         c = 0, 1, 2
//   xw[k * O + o, i, j] = p_0 / p_2,  yw[k * O + o, i, j] = p_1 / p_2
//
// ar = A r ([H, W2, 3]), ac0 = A c0, ac1 = A c1 and b ([3] each) are view
// v's and stay in torch (a few small launches per view, not per unit);
// mr, mc0, mc1 [kc, H, W2] are the candidates' plane terms.  Every
// operation is the torch expression's, in its order and rounded on its
// own, so the positions are bit-equal to warped_coords': NaN and inf pass
// through (a degenerate plane, d = 0, gives inf or NaN positions, which
// the sampler and the window sum turn into MAXCOST).
//
// Bound: bytes.  Per position 8 B out (xw and yw); the plane terms are
// 1/O of that and the offset table is read at one address by a whole
// warp.  Design: one thread per (k, n), neighbouring n in neighbouring
// threads; a thread computes its candidate's u, ax, ay once, in registers,
// and loops over the O offsets, so each offset's stores of a warp are one
// coalesced line of xw and one of yw.  The offset loop is compiled for
// the presets' windows (O = 36: box 11, O = 64: box 15, increment 2) and
// once for any other O.  Capture-safe: every per-view value is read from
// device memory, nothing is allocated, the launch is on the caller's
// stream.
//
// ---- The window epilogue --------------------------------------------------
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

// table: [O, 2] f32 (dx, dy) in the sampled list's order.
template <int kO>
__global__ void __launch_bounds__(256) exact_warp_coords_kernel(
    const float* __restrict__ ar, const float* __restrict__ ac0,
    const float* __restrict__ ac1, const float* __restrict__ b,
    const float* __restrict__ mr, const float* __restrict__ mc0,
    const float* __restrict__ mc1, const float* __restrict__ table,
    float* __restrict__ xw, float* __restrict__ yw, const int kc,
    const int O_, const long long N) {
  const int O = kO > 0 ? kO : O_;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)kc * N) return;
  const long long k = idx / N;
  const long long n = idx - k * N;
  const float tr = __ldg(mr + idx), t0 = __ldg(mc0 + idx),
              t1 = __ldg(mc1 + idx);
  float u[3], ax[3], ay[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bc = __ldg(b + c);
    u[c] = __fsub_rn(__ldg(ar + 3 * n + c), __fmul_rn(bc, tr));
    ax[c] = __fsub_rn(__ldg(ac0 + c), __fmul_rn(bc, t0));
    ay[c] = __fsub_rn(__ldg(ac1 + c), __fmul_rn(bc, t1));
  }
  float* xo = xw + (size_t)k * O * N + n;
  float* yo = yw + (size_t)k * O * N + n;
#pragma unroll 8
  for (int o = 0; o < O; ++o) {
    const float dx = __ldg(table + 2 * o);
    const float dy = __ldg(table + 2 * o + 1);
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = __fadd_rn(__fadd_rn(u[c], __fmul_rn(dx, ax[c])),
                       __fmul_rn(dy, ay[c]));
    xo[(size_t)o * N] = __fdiv_rn(p[0], p[2]);
    yo[(size_t)o * N] = __fdiv_rn(p[1], p[2]);
  }
}

template <int kO>
int launch_warp(const void* ar, const void* ac0, const void* ac1,
                const void* b, const void* mr, const void* mc0,
                const void* mc1, const void* table, void* xw, void* yw,
                int kc, int O, long long N, long long blocks,
                cudaStream_t stream) {
  exact_warp_coords_kernel<kO><<<(unsigned)blocks, 256, 0, stream>>>(
      (const float*)ar, (const float*)ac0, (const float*)ac1,
      (const float*)b, (const float*)mr, (const float*)mc0,
      (const float*)mc1, (const float*)table, (float*)xw, (float*)yw, kc, O,
      N);
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

extern "C" int gtt_exact_warp_coords(
    const void* ar, const void* ac0, const void* ac1, const void* b,
    const void* mr, const void* mc0, const void* mc1, const void* table,
    void* xw, void* yw, int kc, int O, int H, int W2, void* stream) {
  const long long N = (long long)H * W2;
  const long long total = (long long)kc * N;
  if (total <= 0 || O <= 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (O == 36)
    return launch_warp<36>(ar, ac0, ac1, b, mr, mc0, mc1, table, xw, yw, kc,
                           O, N, blocks, s);
  if (O == 64)
    return launch_warp<64>(ar, ac0, ac1, b, mr, mc0, mc1, table, xw, yw, kc,
                           O, N, blocks, s);
  return launch_warp<0>(ar, ac0, ac1, b, mr, mc0, mc1, table, xw, yw, kc, O,
                        N, blocks, s);
}
