// One-pass 2-D nearest permutation for Hopper (sm_90a).
//
// Replaces the two NEAREST passes of gipuma_tpu/ops/pallas_rowgather.py::
// _row_gather_kernel (masked variant :195) that carry every
// gipuma_tpu/ops/permute2d.permute2d, with their two transposes.  A TPU
// gathers only along lanes, so the JAX package routes a 2-D permutation
// through a row gather, a transpose and a second row gather; a Hopper
// thread gathers in 2-D directly, so one pass computes their composite:
//
//   ri  = min(max((int)(clip(R[s, l], 0, in_h-1) + 0.5), 0), in_h-1)
//   col = min(max((int)(clip(C1[ri, l], 0, in_w-1) + 0.5), 0), in_w-1)
//   out[c, s, l] = x[c, ri, col]
//
// index for index the two passes' result (pass 2's row, then pass 1's
// column at that row), NaN table entries included (clip reads them as 0).
// 32-bit words are copied as they are, so int32-packed f16 pairs pass
// through bit-exactly.  The optional mask is pass 2's: [ceil(out_w/8),
// ceil(out_h/128)] tiles of the TRANSPOSED [out_w, out_h] output, tile
// (l >> 3, s >> 7); outputs of an off tile are left unwritten
// (unspecified).  Pass 1's mask needs no test: where it is off, the
// two-pass chain was unspecified too.
//
// Bound: bytes.  Per output word R (4 B) and the C1 entry at (ri, l) once
// each, one source word per channel and one output word per channel; no
// arithmetic to speak of.  Design: one thread per output (s, l), threads
// along l, so R loads and output stores coalesce and C1[ri, l] (ri varies
// slowly along l) mostly does; channels are looped inside, so the two
// indices are computed once.  The intermediate [C, in_h, out_w] of the two
// passes, and both transposes, never touch device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
permute2d_kernel(const int32_t* __restrict__ x, const float* __restrict__ c1,
                 const float* __restrict__ r, const int32_t* __restrict__ tm,
                 int32_t* __restrict__ out, int C, int in_h, int in_w,
                 int out_h, int out_w, int tm_w) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (l >= out_w || s >= out_h) return;
  if (tm != nullptr && __ldg(tm + (l >> 3) * tm_w + (s >> 7)) == 0) return;
  const float rv = fminf(fmaxf(__ldg(r + s * out_w + l), 0.0f),
                         (float)(in_h - 1));
  const int ri = min(max((int)(rv + 0.5f), 0), in_h - 1);
  const float cv = fminf(fmaxf(__ldg(c1 + ri * out_w + l), 0.0f),
                         (float)(in_w - 1));
  const int col = min(max((int)(cv + 0.5f), 0), in_w - 1);
  const int32_t* src = x + ri * in_w + col;
  int32_t* o = out + s * out_w + l;
  const int in_plane = in_h * in_w, out_plane = out_h * out_w;
  for (int c = 0; c < C; ++c) o[c * out_plane] = __ldg(src + c * in_plane);
}

}  // namespace

extern "C" int gtt_permute2d(const void* x, const void* c1, const void* r,
                             const void* tm, void* out, int C, int in_h,
                             int in_w, int out_h, int out_w, int tm_w,
                             void* stream) {
  if (C <= 0 || out_h <= 0 || out_w <= 0) return 0;
  dim3 block(128, 2);
  dim3 grid((out_w + 127) / 128, (out_h + 1) / 2);
  permute2d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const float*)c1, (const float*)r,
      (const int32_t*)tm, (int32_t*)out, C, in_h, in_w, out_h, out_w, tm_w);
  return (int)cudaGetLastError();
}
