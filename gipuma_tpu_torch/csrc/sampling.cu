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
// -fmad=false), so every route is bit-equal to the plain torch version.
//
// Bound: bytes.  Per sample 8 B of coordinates in and 4*C B out, the source
// read once: at DTU's unit (B = 64 offsets x N = 1200 x 800 pixels, C = 3)
// 1.25 GB, 0.374 ms at 3.35 TB/s.  The taps come from the source, which
// stays in the 50 MB L2; what limits a gather is how many distinct 128-B
// lines one warp instruction touches (the L1 serves one a cycle).
//
// Why one thread a sample missed the bound.  Its warp is 32 neighbouring
// pixels at one window offset.  Each pixel carries its own candidate plane
// (random at init, perturbed per pixel by refinement), so where the planes
// differ the 32 lanes land ~30 lines apart: the DTU launch took 2.4-3.0 ms
// at init, in the first two iterations and in refinement, 0.9 ms on the
// last propagation sweeps and on an identity warp.  And the 64 offsets of
// one pixel, whose windows overlap in the source, ran in 64 blocks far
// apart, so the L1 never kept that reuse.
//
// Tiled design.  A block takes a tile of TB consecutive rows b (window
// offsets, candidate-major as per_view_costs_batch lays them out) x
// TILE_N = 32 consecutive pixels n: it loads the tile's x, y into shared
// memory as coalesced rows of n, then each warp takes one pixel at a time
// with its lanes across the pixel's offsets, so one gather instruction
// reads one pixel's window, compact in the source whatever the
// neighbouring planes are, and the pixels of the strip that follow reuse
// its lines from the L1 where the planes agree.  The samples go to shared
// memory and leave as coalesced 128-B rows of n into out[b, c, n].
// Channels are staged STAGE_C at a time (one pass for the exact path's C =
// 3, three for colour's 9).  Shared rows are padded by one word, and in
// the 64-row tile a row is kept at the slot of the lane that reads it, so
// neither the staging nor the gather has bank conflicts.  Indices inside a
// tile are 32-bit; only row starts are 64-bit.  On an H100 at DTU's unit
// the 64-row tile takes 1.06 ms on the random-init field and 0.83-0.95 ms
// on late-iteration and identity fields (one thread a sample: 2.98 and
// 0.87-0.96 ms).  With its gather taken out it still takes ~0.78 ms: the
// staging and the stores, not the gather, now keep it from the bound.
// Wider tiles (64-256 pixels), x, y and samples sharing one buffer,
// cp.async staging and persistent double-buffered blocks were each no
// faster.
//
// Routes, by B (ops/sampling.sampler_route): the 64-row tile where B is a
// whole number of 64-offset windows (PM at box 15, increment 2: an 8 x 8
// dx-major window, whose lanes take 8 columns x 4 rows, so an instruction
// reads 4 source rows and not 8); the 32-row tile for any other B >= 32;
// one thread a sample below 32 rows (CENSUS's centre sample, B = the
// candidates), where lanes across b would idle.  Every route is one launch.
// The TPU kernel's 128-column block split, 8-row tile spans and VMEM
// dynamic_gather exist for the TPU's lack of a general gather and are not
// carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_N = 32;    // pixels of a tile
constexpr int PAD_N = TILE_N + 1;
constexpr int STAGE_C = 3;    // channels staged at once

// clip that propagates NaN (comparisons with NaN are false).
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One position's taps: the top-left texel's index in a plane and the
// lerp weights.
struct Taps {
  int off;
  float fx, fy, gx, gy;
};

__device__ __forceinline__ Taps taps_at(float xv, float yv, int H, int W) {
  const float xx = clip_nan(xv, 0.0f, (float)(W - 1));
  const float yy = clip_nan(yv, 0.0f, (float)(H - 1));
  // (int)NaN is 0 on the device; the integer clamp keeps every tap in range.
  const int x0 = min(max((int)floorf(xx), 0), W - 2);
  const int y0 = min(max((int)floorf(yy), 0), H - 2);
  Taps t;
  t.fx = clip_nan(__fsub_rn(xx, (float)x0), 0.0f, 1.0f);
  t.fy = clip_nan(__fsub_rn(yy, (float)y0), 0.0f, 1.0f);
  t.gx = __fsub_rn(1.0f, t.fx);
  t.gy = __fsub_rn(1.0f, t.fy);
  t.off = y0 * W + x0;
  return t;
}

// The lerp of one channel plane p at taps t.
__device__ __forceinline__ float lerp(const float* __restrict__ p, int W,
                                      const Taps& t) {
  const float v00 = __ldg(p), v01 = __ldg(p + 1);
  const float v10 = __ldg(p + W), v11 = __ldg(p + W + 1);
  const float top = __fadd_rn(__fmul_rn(v00, t.gx), __fmul_rn(v01, t.fx));
  const float bot = __fadd_rn(__fmul_rn(v10, t.gx), __fmul_rn(v11, t.fx));
  return __fadd_rn(__fmul_rn(top, t.gy), __fmul_rn(bot, t.fy));
}

// Route 0: one thread a sample, looping over the C channels.
__global__ void bilinear_sample_kernel(const float* __restrict__ src,
                                       const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       float* __restrict__ out, int C, int H,
                                       int W, long long N, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / N;
  const long long n = i - b * N;
  const Taps t = taps_at(__ldg(x + i), __ldg(y + i), H, W);
  const size_t plane = (size_t)H * W;
  const float* s = src + t.off;
  float* o = out + (size_t)b * C * N + n;
  for (int c = 0; c < C; ++c) o[(size_t)c * N] = lerp(s + c * plane, W, t);
}

// The tile row that lane `lane` reads in its h-th instruction of a pixel,
// and the shared slot that row is kept at.  32 rows: row = slot = lane.
// 64 rows: 8 window columns x 4 rows (rows 8 col + 4 h + lane / 8 of the
// dx-major 8 x 8 window, col = lane % 8), kept at slot lane + 32 h.
template <int TB>
__device__ __forceinline__ int row_of(int lane, int h) {
  return TB == 64 ? (lane & 7) * 8 + 4 * h + (lane >> 3) : lane + 32 * h;
}

template <int TB>
__device__ __forceinline__ int slot_of(int r) {
  if (TB != 64) return r;
  const int col = r >> 3, rem = r & 7;
  return (rem & 3) * 8 + col + 32 * (rem >> 2);
}

// Routes 32 and 64: a tile of TB rows x TILE_N pixels a block; tile t is
// pixel strip t / nbt, row block t % nbt.  A block holds 2048 / THREADS of
// an SM's threads, so the launch bound lets four blocks (32 registers a
// thread) share an SM.  The staging, gather and store loops have fixed
// trip counts and are unrolled: each thread issues all its loads of a
// phase before it waits on any.
template <int TB, int THREADS>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
    bilinear_sample_kernel_tiled(const float* __restrict__ src,
                                 const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 float* __restrict__ out, int C, int H, int W,
                                 int N, int B, int nbt) {
  constexpr int WARPS = THREADS / 32;
  constexpr int PER = TB * TILE_N / THREADS;  // positions a thread stages
  static_assert(PER * THREADS == TB * TILE_N && TILE_N % WARPS == 0,
                "a tile splits evenly over the block's threads and warps");
  __shared__ float xs[TB * PAD_N], ys[TB * PAD_N];
  __shared__ float ss[TB * STAGE_C * PAD_N];
  const int b0 = (blockIdx.x % nbt) * TB;
  const int n0 = (blockIdx.x / nbt) * TILE_N;
  const int nb = min(TB, B - b0), nn = min(TILE_N, N - n0);
  float vx[PER], vy[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / TILE_N, j = i % TILE_N;
    if (r < nb && j < nn) {
      const size_t g = (size_t)(b0 + r) * N + (n0 + j);
      vx[k] = __ldg(x + g);
      vy[k] = __ldg(y + g);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / TILE_N, j = i % TILE_N;
    if (r < nb && j < nn) {
      const int q = slot_of<TB>(r) * PAD_N + j;
      xs[q] = vx[k];
      ys[q] = vy[k];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  for (int c0 = 0; c0 < C; c0 += STAGE_C) {
    const float* sc = src + (size_t)c0 * plane;
#pragma unroll
    for (int jj = 0; jj < TILE_N / WARPS; ++jj) {
      const int j = warp + jj * WARPS;
      if (j >= nn) break;
#pragma unroll
      for (int h = 0; h < TB / 32; ++h) {
        const int q = lane + 32 * h;
        if (row_of<TB>(lane, h) < nb) {
          const Taps t = taps_at(xs[q * PAD_N + j], ys[q * PAD_N + j], H, W);
          const float* s = sc + t.off;
#pragma unroll
          for (int cc = 0; cc < STAGE_C; ++cc)
            if (c0 + cc < C)
              ss[(q * STAGE_C + cc) * PAD_N + j] = lerp(s + cc * plane, W, t);
        }
      }
    }
    __syncthreads();
    const int cn = min(STAGE_C, C - c0);
#pragma unroll 4
    for (int i = threadIdx.x; i < TB * STAGE_C * TILE_N; i += THREADS) {
      const int row = i / TILE_N, j = i % TILE_N;
      const int r = row / STAGE_C, cc = row - r * STAGE_C;
      if (r < nb && cc < cn && j < nn)
        out[((size_t)(b0 + r) * C + c0 + cc) * N + (n0 + j)] =
            ss[(slot_of<TB>(r) * STAGE_C + cc) * PAD_N + j];
    }
    __syncthreads();  // before the next channels overwrite ss
  }
}

template <int TB, int THREADS>
int launch_tiled(const float* src, const float* x, const float* y,
                 float* out, int C, int H, int W, long long N, long long B,
                 cudaStream_t stream) {
  const long long nbt = (B + TB - 1) / TB;
  const long long tiles = nbt * ((N + TILE_N - 1) / TILE_N);
  if (N > 2147483647LL || B > 2147483647LL || tiles > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  bilinear_sample_kernel_tiled<TB, THREADS>
      <<<(unsigned)tiles, THREADS, 0, stream>>>(src, x, y, out, C, H, W,
                                                (int)N, (int)B, (int)nbt);
  return (int)cudaGetLastError();
}

}  // namespace

// route: 0 (one thread a sample), 32 or 64 (the tiles); ops/sampling.py
// picks it by B (sampler_route).
extern "C" int gtt_bilinear_sample(const void* src, const void* x,
                                   const void* y, void* out, int C, int H,
                                   int W, long long N, long long B, int route,
                                   void* stream) {
  const long long total = N * B;
  if (total <= 0 || C <= 0) return 0;
  if ((long long)H * W > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const float* s = (const float*)src;
  const float* px = (const float*)x;
  const float* py = (const float*)y;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 64)
    return launch_tiled<64, 512>(s, px, py, o, C, H, W, N, B, st);
  if (route == 32)
    return launch_tiled<32, 256>(s, px, py, o, C, H, W, N, B, st);
  if (route != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  bilinear_sample_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      s, px, py, o, C, H, W, N, total);
  return (int)cudaGetLastError();
}
