// Linear row gather for Hopper (sm_90a): f32, PACKED and PACKED+GFWD.
//
// Replaces gipuma_tpu/ops/pallas_rowgather.py::_row_gather_kernel in its
// lerp modes (the full-channel, grad_fwd and f32 rect cost layouts, and
// census on an f32 layout):
//
//   xx  = clip(x[b, i, j], 0, W-1)
//   x0  = min(max(floor(xx), 0), W-2)       (tap index; 0 for a NaN xx)
//   fx  = clip(xx - x0, 0, 1)
//   out[b, c, i, j] = v0 * (1 - fx) + v1 * fx
//
// with (v0, v1) = src[c, r, x0], src[c, r, x0 + 1] for an f32 source, or
// the bf16 pair of the int32 word src[c, r, x0] (high half v0, low half
// v1; pure bit work) when PACKED.  r = clip(i + src_dy, 0, H-1): the
// callers' edge-replicated row shift.  GFWD: the C words are [C/2 image
// words, C/2 y-gradient words] and the output's 3C/2 channels are
// [img lerp, gx = 2 (v1 - v0) of the image word, gy lerp].
//
// Clips are comparisons (NaN stays NaN, so a degenerate position gives a
// NaN sample and the caller's cost becomes MAXCOST); the integer tap
// index is clamped on its own so a NaN position reads in-range memory.
// Products and sums are __fmul_rn / __fadd_rn in the plain version's
// order (never contracted to an FMA), so the kernel is bit-equal to it.
//
// Bound: bytes.  Per output sample: x once (4 B, shared by all channels),
// one source word (PACKED) or two taps (f32) per channel from a row that
// stays in L1/L2, and 4 B written per output channel.  Design: one thread
// per (b, i, j) looping over channels, so x is read and the tap index
// computed once; a block is 128 consecutive j of one row, so neighbouring
// threads write neighbouring addresses.  The TPU kernel's 128-column block
// scan and scratch windows do not exist here: each thread reads its own
// tap address.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nclip(float v, float lo, float hi) {
  // As jnp.clip: NaN passes through.
  if (v != v) return v;
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp(float v0, float v1, float fx) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, fx)), __fmul_rn(v1, fx));
}

__device__ __forceinline__ void unpack(int32_t w, float& v0, float& v1) {
  v0 = __int_as_float(w & (int32_t)0xFFFF0000);
  v1 = __int_as_float((int32_t)((uint32_t)w << 16));
}

template <bool PACKED, bool GFWD>
__global__ void __launch_bounds__(128) row_gather_lerp_kernel(
    const void* __restrict__ src_v, const float* __restrict__ x,
    float* __restrict__ out, int C, int H, int W, int Ws, int src_dy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= Ws) return;
  const float xx = nclip(__ldg(x + ((size_t)b * H + i) * Ws + j), 0.0f,
                         (float)(W - 1));
  const int x0 = xx == xx ? min(max((int)floorf(xx), 0), W - 2) : 0;
  const float fx = nclip(__fsub_rn(xx, (float)x0), 0.0f, 1.0f);
  const int r = min(max(i + src_dy, 0), H - 1);
  const size_t s_plane = (size_t)H * W;
  const size_t s_off = (size_t)r * W + x0;
  const size_t o_plane = (size_t)H * Ws;
  const int co = GFWD ? C + C / 2 : C;
  float* o = out + ((size_t)b * co * H + i) * Ws + j;
  if (!PACKED) {
    const float* s = (const float*)src_v + s_off;
    for (int c = 0; c < C; ++c)
      o[c * o_plane] = lerp(__ldg(s + c * s_plane), __ldg(s + c * s_plane + 1),
                            fx);
    return;
  }
  const int32_t* s = (const int32_t*)src_v + s_off;
  const int half = C / 2;
  for (int c = 0; c < C; ++c) {
    float v0, v1;
    unpack(__ldg(s + c * s_plane), v0, v1);
    if (!GFWD) {
      o[c * o_plane] = lerp(v0, v1, fx);
    } else if (c < half) {          // image word: img and gx
      o[c * o_plane] = lerp(v0, v1, fx);
      o[(half + c) * o_plane] = __fmul_rn(2.0f, __fsub_rn(v1, v0));
    } else {                        // y-gradient word
      o[(half + c) * o_plane] = lerp(v0, v1, fx);
    }
  }
}

}  // namespace

extern "C" int gtt_row_gather_lerp(const void* src, const void* x, void* out,
                                   int B, int C, int H, int W, int Ws,
                                   int src_dy, int packed, int gfwd,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Ws <= 0 || C <= 0) return 0;
  if (W < 2 || (gfwd && (!packed || C % 2))) return (int)cudaErrorInvalidValue;
  dim3 block(128);
  dim3 grid((Ws + 127) / 128, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  if (!packed)
    row_gather_lerp_kernel<false, false><<<grid, block, 0, s>>>(
        src, xf, of, C, H, W, Ws, src_dy);
  else if (!gfwd)
    row_gather_lerp_kernel<true, false><<<grid, block, 0, s>>>(
        src, xf, of, C, H, W, Ws, src_dy);
  else
    row_gather_lerp_kernel<true, true><<<grid, block, 0, s>>>(
        src, xf, of, C, H, W, Ws, src_dy);
  return (int)cudaGetLastError();
}
