// Packed row gather at in-kernel affine positions, for Hopper (sm_90a).
//
// Replaces gipuma_tpu/ops/pallas_rowgather.py::_row_gather_affine_kernel
// (the census rect cost and the unfused window_grads cost).  For candidate
// k, column offset dxs[e] and rect pixel (i, j):
//
//   xse  = (float)(j + dxs[e])
//   disp = clip((a * xse + b * ((float)i + dy)) + c, lo, hi)
//   xx   = clip(xse - disp, 0, W-1)
//   x0   = min(max(floor(xx), 0), W-2)      (tap index; 0 for a NaN xx)
//   fx   = clip(xx - x0, 0, 1)
//   out[k*E + e, c, i, j] = v0 * (1 - fx) + v1 * fx
//
// with (a, b, c) = abc[k, :, i, j], (lo, hi) = db[0], db[1] read from the
// device (so the view loop never syncs with the host), and (v0, v1) the
// bf16 pair of the int32 word src[c, clip(i + src_dy, 0, H-1), x0].  dy is
// the window row offset of the disparity, src_dy the callers' edge-
// replicated source row shift (the same value in every caller).
//
// Clips are comparisons (NaN stays NaN: a degenerate plane gives NaN
// samples, then a MAXCOST cost); the tap index is clamped on its own so a
// NaN position reads in-range memory.  Products and sums are __fmul_rn /
// __fadd_rn in the plain version's order, so the kernel is bit-equal to it.
//
// Bound: bytes.  Per (k, pixel): abc 12 B read once; per (k, e, c, pixel):
// one 4-byte source word from a row that stays in L1/L2 and 4 B written;
// the source itself once.  Design: one thread per (k, i, j) reads its
// (a, b, c) once and loops over the E offsets and C channels; a block is
// 128 consecutive j of one row, so loads of abc and stores of each output
// plane are coalesced.  The column offsets ride in the launch arguments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDxs = 64;

struct Dxs {
  int v[kMaxDxs];
};

__device__ __forceinline__ float nclip(float v, float lo, float hi) {
  // As jnp.clip: NaN passes through.
  if (v != v) return v;
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(128) row_gather_affine_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ abc,
    const float* __restrict__ db, float* __restrict__ out, const Dxs dxs,
    int E, int C, int H, int W, int Ws, int src_dy, float dy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int k = blockIdx.z;
  if (j >= Ws) return;
  const size_t P = (size_t)H * Ws;
  const size_t pix = (size_t)i * Ws + j;
  const float a = __ldg(abc + (size_t)(3 * k + 0) * P + pix);
  const float b = __ldg(abc + (size_t)(3 * k + 1) * P + pix);
  const float c0 = __ldg(abc + (size_t)(3 * k + 2) * P + pix);
  const float lo = __ldg(db), hi = __ldg(db + 1);
  const float by = __fmul_rn(b, __fadd_rn((float)i, dy));
  const float wmax = (float)(W - 1);
  const int r = min(max(i + src_dy, 0), H - 1);
  const int32_t* srow = src + (size_t)r * W;
  const size_t s_plane = (size_t)H * W;
  for (int e = 0; e < E; ++e) {
    const float xse = (float)(j + dxs.v[e]);
    const float disp =
        nclip(__fadd_rn(__fadd_rn(__fmul_rn(a, xse), by), c0), lo, hi);
    const float xx = nclip(__fsub_rn(xse, disp), 0.0f, wmax);
    const int x0 = xx == xx ? min(max((int)floorf(xx), 0), W - 2) : 0;
    const float fx = nclip(__fsub_rn(xx, (float)x0), 0.0f, 1.0f);
    const float omf = __fsub_rn(1.0f, fx);
    float* o = out + ((size_t)(k * E + e) * C) * P + pix;
    for (int c = 0; c < C; ++c) {
      const int32_t w = __ldg(srow + c * s_plane + x0);
      const float v0 = __int_as_float(w & (int32_t)0xFFFF0000);
      const float v1 = __int_as_float((int32_t)((uint32_t)w << 16));
      o[c * P] = __fadd_rn(__fmul_rn(v0, omf), __fmul_rn(v1, fx));
    }
  }
}

}  // namespace

extern "C" int gtt_row_gather_affine(const void* src, const void* abc,
                                     const void* db, void* out,
                                     const int* dxs, int E, int K, int C,
                                     int H, int W, int Ws, int src_dy,
                                     float dy, void* stream) {
  if (K <= 0 || H <= 0 || Ws <= 0 || C <= 0) return 0;
  if (E <= 0 || E > kMaxDxs || W < 2) return (int)cudaErrorInvalidValue;
  Dxs d{};
  for (int e = 0; e < E; ++e) d.v[e] = dxs[e];
  dim3 block(128);
  dim3 grid((Ws + 127) / 128, H, K);
  row_gather_affine_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const float*)abc, (const float*)db, (float*)out,
      d, E, C, H, W, Ws, src_dy, dy);
  return (int)cudaGetLastError();
}
