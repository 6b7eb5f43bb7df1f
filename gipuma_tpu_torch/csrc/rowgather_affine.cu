// Packed row gather at in-kernel affine positions, for Hopper (sm_90a).
//
// Replaces gipuma_tpu/ops/pallas_rowgather.py::_row_gather_affine_kernel
// (the census rect cost and the unfused window_grads cost).  For window row
// r (disparity row offset dys[r], source row shift src_dys[r]), candidate
// k, column offset dxs[e] and rect pixel (i, j):
//
//   xse  = (float)(j + dxs[e])
//   disp = clip((a * xse + b * ((float)i + dys[r])) + c, lo, hi)
//   xx   = clip(xse - disp, 0, W-1)
//   x0   = min(floor(xx), W-2)      (a tap in range for a NaN xx)
//   fx   = xx - x0                  (in [0, 1], or NaN)
//   out[r, k*E + e, c, i, j] = v0 * (1 - fx) + v1 * fx
//
// with (a, b, c) = abc[k, :, i, j], (lo, hi) = db[0], db[1] read from the
// device (so the view loop never syncs with the host), and (v0, v1) the
// bf16 pair of the int32 word src[c, clip(i + src_dys[r], 0, H-1), x0].
// One launch serves the R window rows of a (view, evaluation); R = 1 is the
// JAX kernel's one-row call.
//
// Clips propagate NaN (min.NaN / max.NaN, as torch.minimum / maximum): a
// degenerate plane gives NaN samples, then a MAXCOST cost.  Products and
// sums are __fmul_rn / __fadd_rn in the plain version's order, and the
// source is built without FMA contraction, so the kernel is bit-equal to
// the plain version.
//
// Bound: bytes.  abc 12 B per (k, pixel), read once for all R rows; 4 B
// written per (r, k, e, c, pixel), ~78% of the bytes of the one-row call
// and more of a rows call; the source once.  About 20 instructions per
// output, so the issue rate is the second limit.  Design:
// - a block is one rect row i, one candidate k, a strip of up to 1024
//   columns and a group of up to kRowsPerBlock window rows (the grid's
//   fastest index, so the groups of one (k, i) run together and re-read
//   abc from L2); candidates are grid blocks, not a loop in the block, so
//   a one-row call at K = 4 fills several waves of the card;
// - the block stages its source rows, all C channels, in shared memory
//   with cp.async (16-byte copies where the row is aligned), so every
//   K*E*C gather is a shared-memory load; a row of C*W words that exceeds
//   kSmemBudget is read from global memory instead (the global branch);
// - a thread owns kV = 4 consecutive columns: 16-byte loads of a, b, c
//   and 16-byte streaming stores to every output plane when Ws % 4 == 0
//   (evict-first: the output exceeds L2, so abc and the source rows stay);
// - E is a template argument for the callers' column counts (census 11, 9,
//   1; unfused one-sided 6, 3, two-sided 8, 5): the offsets loop unrolls,
//   the offsets are constant-bank operands and all the positions of one
//   offset are computed before its loads; other E take a generic loop;
// - 32-bit arithmetic but for the plane bases (one 64-bit product per
//   window row and plane).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDxs = 64;
constexpr int kMaxRows = 64;
constexpr int kV = 4;                  // consecutive columns per thread
static_assert(kV % 4 == 0, "16-byte loads and stores of kV columns");
constexpr int kMaxThreads = 256;       // kV * 256 = 1024 columns per strip
constexpr int kRowsPerBlock = 4;
constexpr int kSmemBudget = 48 * 1024; // bytes of staged source per block

struct Args {
  const int32_t* src;   // [C, H, W] packed bf16 tap pairs
  const float* abc;     // [K, 3, H, Ws]
  const float* db;      // [2] disparity clamp (lo, hi)
  float* out;           // [R, K*E, C, H, Ws]
  float dx[kMaxDxs];    // column offsets (integers, exact as floats)
  float dy[kMaxRows];   // disparity row offsets
  int sdy[kMaxRows];    // source row shifts
  int E, K, C, H, W, Ws, R;
  int G, nG;            // window rows per block, row groups
  int strip;            // columns per block (a multiple of kV)
  int vec;              // Ws % kV == 0: 16-byte abc loads and out stores
  int stage16;          // 16-byte staging copies
};

// NaN-propagating min / max / clip, as torch.minimum / maximum / clamp.
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nclip(float v, float lo, float hi) {
  return nmin(nmax(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void load4(const float* g, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(g));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Rows of the staged source (or of global memory on the global branch).
template <bool SMEM>
struct SrcRow {
  const int32_t* row;   // channel 0 of the source row
  int cstride;          // words between channels
  __device__ __forceinline__ int32_t at(int c, unsigned x) const {
    if (SMEM) return row[c * cstride + x];
    return __ldg(row + c * cstride + x);
  }
};

template <int E_T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
    row_gather_affine_kernel(const __grid_constant__ Args p) {
  extern __shared__ int32_t srows[];   // [G][C][W]
  const int i = blockIdx.y;
  const int g = blockIdx.x % p.nG;
  const int kb = blockIdx.x / p.nG;
  const int k = kb % p.K;
  const int strip = kb / p.K;
  const int r0 = g * p.G;
  const int nr = min(p.G, p.R - r0);
  const int C = p.C, W = p.W, H = p.H, Ws = p.Ws;

  if (SMEM) {
    for (int rr = 0; rr < nr; ++rr) {
      const int sr = min(max(i + p.sdy[r0 + rr], 0), H - 1);
      for (int c = 0; c < C; ++c) {
        const int32_t* gs = p.src + ((size_t)c * H + sr) * W;
        int32_t* s = srows + (rr * C + c) * W;
        if (p.stage16) {
          for (int x = threadIdx.x * 4; x < W; x += blockDim.x * 4)
            cp_async16(s + x, gs + x);
        } else {
          for (int x = threadIdx.x; x < W; x += blockDim.x)
            cp_async4(s + x, gs + x);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int j0 = strip * p.strip + threadIdx.x * kV;
  const int jend = min(Ws, (strip + 1) * p.strip);
  if (j0 >= jend) return;              // no barrier follows
  const int n = min(kV, Ws - j0);      // kV unless at the tail (Ws % 4)
  const size_t P = (size_t)H * Ws;
  const size_t pix = (size_t)i * Ws + j0;

  float a[kV], b[kV], c0[kV], fj[kV];
  const float* ak = p.abc + (size_t)(3 * k) * P + pix;
  if (p.vec) {
#pragma unroll
    for (int h = 0; h < kV; h += 4) {
      load4(ak + h, a + h);
      load4(ak + P + h, b + h);
      load4(ak + 2 * P + h, c0 + h);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const bool in = q < n;
      a[q] = in ? __ldg(ak + q) : 0.0f;
      b[q] = in ? __ldg(ak + P + q) : 0.0f;
      c0[q] = in ? __ldg(ak + 2 * P + q) : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kV; ++q) fj[q] = (float)(j0 + q);
  const float lo = __ldg(p.db), hi = __ldg(p.db + 1);
  const float wmax = (float)(W - 1);
  const unsigned tmax = (unsigned)(W - 2);
  const int E = E_T > 0 ? E_T : p.E;

  for (int rr = 0; rr < nr; ++rr) {
    const int r = r0 + rr;
    SrcRow<SMEM> src;
    if (SMEM) {
      src.row = srows + rr * C * W;
      src.cstride = W;
    } else {
      src.row = p.src + (size_t)min(max(i + p.sdy[r], 0), H - 1) * W;
      src.cstride = H * W;
    }
    const float fy = __fadd_rn((float)i, p.dy[r]);
    float by[kV];
#pragma unroll
    for (int q = 0; q < kV; ++q) by[q] = __fmul_rn(b[q], fy);
    float* o = p.out + (size_t)((r * p.K + k) * E) * C * P + pix;

    auto column = [&](int e) {
      unsigned x0[kV];
      float fx[kV];
#pragma unroll
      for (int q = 0; q < kV; ++q) {
        const float xse = __fadd_rn(fj[q], p.dx[e]);
        const float disp = nclip(
            __fadd_rn(__fadd_rn(__fmul_rn(a[q], xse), by[q]), c0[q]), lo, hi);
        const float xx = nclip(__fsub_rn(xse, disp), 0.0f, wmax);
        // floor(xx) for xx in [0, W-1]; an unsigned clamp keeps the tap of
        // a NaN xx in range (fx stays NaN).
        x0[q] = min((unsigned)__float2int_rd(xx), tmax);
        fx[q] = __fsub_rn(xx, (float)x0[q]);
      }
      float* oe = o + (size_t)e * C * P;
      for (int c = 0; c < C; ++c) {
        float v[kV];
#pragma unroll
        for (int q = 0; q < kV; ++q) {
          const int32_t w = src.at(c, x0[q]);
          const float v0 = __int_as_float(w & (int32_t)0xFFFF0000);
          const float v1 = __int_as_float((int32_t)((uint32_t)w << 16));
          v[q] = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, fx[q])),
                           __fmul_rn(v1, fx[q]));
        }
        float* oc = oe + (size_t)c * P;
        if (p.vec) {
#pragma unroll
          for (int h = 0; h < kV; h += 4)
            __stcs(reinterpret_cast<float4*>(oc + h),
                   make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]));
        } else {
#pragma unroll
          for (int q = 0; q < kV; ++q)
            if (q < n) oc[q] = v[q];
        }
      }
    };
    if constexpr (E_T > 0) {
#pragma unroll
      for (int e = 0; e < E_T; ++e) column(e);
    } else {
      for (int e = 0; e < E; ++e) column(e);
    }
  }
}

// The launch geometry of a call: rows per block G (and groups nG), whether
// the source rows are staged in shared memory (their bytes), columns per
// block and threads per block.
struct Geometry {
  int G, nG, smem_bytes, strip, threads, nstrip;
};

Geometry geometry(int R, int C, int W, int Ws) {
  Geometry g{};
  const long row_bytes = 4L * C * W;
  g.nG = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  g.G = (R + g.nG - 1) / g.nG;
  if (row_bytes <= kSmemBudget) {
    const int fit = (int)(kSmemBudget / row_bytes);
    if (g.G > fit) {
      g.G = fit;
      g.nG = (R + g.G - 1) / g.G;
    }
    g.smem_bytes = (int)(g.G * row_bytes);
  }
  g.nstrip = (Ws + kV * kMaxThreads - 1) / (kV * kMaxThreads);
  const int per = (Ws + g.nstrip - 1) / g.nstrip;
  g.strip = (per + kV - 1) / kV * kV;
  g.threads = ((g.strip / kV + 31) / 32) * 32;
  return g;
}

template <int E_T>
int launch(const Args& p, const Geometry& g, cudaStream_t stream) {
  dim3 grid(g.nG * p.K * g.nstrip, p.H);
  dim3 block(g.threads);
  if (g.smem_bytes > 0)
    row_gather_affine_kernel<E_T, true>
        <<<grid, block, g.smem_bytes, stream>>>(p);
  else
    row_gather_affine_kernel<E_T, false><<<grid, block, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of source staged in shared memory per block for a call of R window
// rows at C channels and width W; 0 when the global branch runs.
extern "C" int gtt_row_gather_affine_staged_rows(int R, int C, int W) {
  const Geometry g = geometry(R, C, W, 1);
  return g.smem_bytes > 0 ? g.G : 0;
}

extern "C" int gtt_row_gather_affine_rows(
    const void* src, const void* abc, const void* db, void* out,
    const int* dxs, int E, const float* dys, const int* src_dys, int R,
    int K, int C, int H, int W, int Ws, void* stream) {
  if (K <= 0 || H <= 0 || Ws <= 0 || C <= 0 || R <= 0) return 0;
  if (E <= 0 || E > kMaxDxs || R > kMaxRows || W < 2 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(R, C, W, Ws);
  if ((long)g.nG * K * g.nstrip > 0x7FFFFFFFL)
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.src = (const int32_t*)src;
  p.abc = (const float*)abc;
  p.db = (const float*)db;
  p.out = (float*)out;
  for (int e = 0; e < E; ++e) p.dx[e] = (float)dxs[e];
  for (int r = 0; r < R; ++r) {
    p.dy[r] = dys[r];
    p.sdy[r] = src_dys[r];
  }
  p.E = E;
  p.K = K;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Ws = Ws;
  p.R = R;
  p.G = g.G;
  p.nG = g.nG;
  p.strip = g.strip;
  p.vec = Ws % kV == 0 && ((uintptr_t)abc % 16) == 0 &&
          ((uintptr_t)out % 16) == 0;
  p.stage16 = W % 4 == 0 && ((uintptr_t)src % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (E) {
    case 1: return launch<1>(p, g, s);
    case 3: return launch<3>(p, g, s);
    case 5: return launch<5>(p, g, s);
    case 6: return launch<6>(p, g, s);
    case 8: return launch<8>(p, g, s);
    case 9: return launch<9>(p, g, s);
    case 11: return launch<11>(p, g, s);
    default: return launch<0>(p, g, s);
  }
}
