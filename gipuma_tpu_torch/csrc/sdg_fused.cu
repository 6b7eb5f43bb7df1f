// Fused window-grads rect cost for Hopper (sm_90a).
//
// Replaces gipuma_tpu/ops/pallas_sdg_fused.py::_sdg_fused_kernel: the
// bilateral-weighted truncated color+gradient window cost of K affine
// disparity candidates on one rectified pair.  Source samples sit at
//   x = (x^ + dx) - clip(a (x^ + dx) + (b (y^ + dy) + c), lo, hi)
// on rect row y^ + dy, read from bf16 tap-pair words and interpolated;
// source gradients are differences of neighbouring window samples,
// Jacobian-corrected (1/(1-a) with |1-a| >= 0.25, + b*gx), one-sided and
// doubled at the window edges when ONESIDED.  NaN or >= MAXCOST becomes
// MAXCOST.  Pixels outside hw_valid or on tiles with tile_ok == 0 are left
// unwritten (unspecified, as on the TPU).
//
// Bound (chip_smoke.fused_bound counts the FP32 operations of the plain
// version's arithmetic): per candidate and pixel, T*E sample positions (8
// operations each, then per channel one 4-byte gather and a 3-operation
// lerp) and NROW*NCOL contributions (about 11C + 6 operations each); per
// pixel, NROW*NCOL bilateral weights (2C + 1 operations, the exp counted
// as one), shared by the K candidates; against K*3 + 4C (ref, src) + K
// words of traffic.
//
// Design.  One block per [8, 128] output tile, the tile_ok / hw_valid
// granularity: the mask is read once and an off tile costs one block that
// exits.
// The block stages the tile's reference channels with their window halo,
// (8 + 2 vr) x (128 + 2 hrad) x 3C floats, in shared memory once (cp.async
// with clamped source addresses, so the edge replication of the reference
// window is the copy's own); every window read after that is a
// conflict-free shared load.  Threads run along the tile's 128 columns;
// kThreadsY of them share its rows, each walking its pixels and, per
// pixel, the K candidates: the bilateral weights depend on the reference
// alone, so with K > 1 they are computed once per pixel and kept in
// registers for all K.  The main path's windows (box 11 / inc 2, box 9 /
// inc 4, box 7 / inc 2) take the tile kernel, whose rows T and step INC
// are template arguments: the row loop is fully unrolled, samples live in
// registers indexed by constants, every offset into the shared tile is an
// immediate, and a row's contributions are emitted one row late, so the
// next row's gathers are in flight while they compute.  Any other window
// takes the generic kernel (runtime row loop over a rolling 3-row register
// buffer; the reference from global memory when its tile does not fit in
// shared memory).  Source samples stay __ldg gathers: they are row-local
// and a tile's neighbours reread its rows from L1/L2 (whether staging them
// would gain is not measured).  Index arithmetic is 32-bit; a candidate's
// products a x are computed once for all rows (RowCols), and the tap index
// comes from a round-down add, not a conversion.  The sample positions are
// rounded with __fmul_rn / __fadd_rn in the plain version's association,
// so they equal its positions bit for bit; the rest of the
// arithmetic may contract to FMA (this source alone is built without
// -fmad=false), the lerp is v0 + fx (v1 - v0) and the weight one ex2.approx:
// the kernel is held to its plain version at 1e-3 abs.  The register budget
// (launch bounds below) and the block shape (kThreadsY) were chosen by
// timing designs against each other on the card
// (scripts/port_kernel_ab.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaxCost = 1000.0f;
constexpr int kTileH = 8;
constexpr int kTileW = 128;
// Threads of a block along its tile's rows (kTileW run along the columns);
// each walks kTileH / kThreadsY pixel rows.
constexpr int kThreadsY = 4;
constexpr int kThreads = kTileW * kThreadsY;
// Resident blocks per SM the launch bounds ask for, i.e. the register
// budget: the tile kernel at C=1 gets 64 registers (two 512-thread blocks
// per SM), at C=3 and the generic kernel 128.
constexpr int kMinBlocksNarrow = 2;
constexpr int kMinBlocksWide = 1;
// Devices the per-device launch state below is kept for.
constexpr int kMaxDevices = 64;

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

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2; the non-ftz form
// adds a compare and two multiplies for the subnormal range).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct Args {
  const float* ref;      // [3C, Hr, Wr]
  const int32_t* src;    // [C, Hr, Wr] packed bf16 tap pairs
  const float* abc;      // [K, 3, Hr, Wr]
  const float* db;       // [2] disparity clamp (lo, hi)
  const int32_t* hwv;    // [2] valid (rows, cols) or null
  const int32_t* tm;     // [ceil(Hr/8), Wr/128] tile mask or null
  float* out;            // [K, Hr, Wr]
  int K, Hr, Wr, tm_w, T, E, NCOL, vr, hrad, inc;
  int smem_ref;          // 1: the reference tile is staged in shared memory
  float alpha, one_m_alpha, w_log2, inv_c, tau_col, tau_grad, grad_scale_c;
};

// Whether tile (ty, tx) is computed at all (uniform per block).
__device__ __forceinline__ bool tile_on(const Args& p, int ty, int tx) {
  if (p.hwv != nullptr &&
      (ty * kTileH >= __ldg(p.hwv) || tx * kTileW >= __ldg(p.hwv + 1)))
    return false;
  return p.tm == nullptr || __ldg(p.tm + ty * p.tm_w + tx) != 0;
}

// Stage the tile's 3C reference channels with the window halo:
// sm[ch][r][c] = ref[ch][clamp(i0 - vr + r)][clamp(j0 - hrad + c)].
template <int C>
__device__ __forceinline__ void stage_ref(const Args& p, float* sm, int i0,
                                          int j0, int pitch, int rows_s) {
  const int P = p.Hr * p.Wr;
  for (int rr = threadIdx.y; rr < 3 * C * rows_s; rr += blockDim.y) {
    const int ch = rr / rows_s;
    const int grow = min(max(i0 - p.vr + (rr - ch * rows_s), 0), p.Hr - 1);
    const float* g = p.ref + ch * P + grow * p.Wr;
    float* s = sm + rr * pitch;
    for (int c = threadIdx.x; c < pitch; c += blockDim.x)
      cp_async4(s + c, g + min(max(j0 - p.hrad + c, 0), p.Wr - 1));
  }
  cp_async_wait_all();
  __syncthreads();
}

// The reference window of one pixel in the shared tile, its steps known at
// compile time: channel ch at contribution row jr and column jj.
template <int RSTEP, int INC>
struct TileWin {
  const float* sm;   // the pixel's (row - vr, col - hrad) corner
  int plane;
  __device__ __forceinline__ float at(int ch, int jr, int jj) const {
    return sm[ch * plane + jr * RSTEP + jj * INC];
  }
};

// The generic kernel's reference window of one pixel: channel ch at
// contribution row jr and column jj, i.e.
// ref[ch][clamp(i - vr + jr inc)][clamp(j - hrad + jj inc)], from the shared
// tile, or from global memory when the tile did not fit there (sm null).
struct RefWin {
  const float* sm;   // the pixel's (row - vr, col - hrad) corner in the
                     // shared tile
  const float* g;
  int plane, rstep, inc;                 // shared tile
  int P, Hr, Wr, i, j, vr, hrad;         // global
  __device__ __forceinline__ float at(int ch, int jr, int jj) const {
    if (sm != nullptr)
      return sm[ch * plane + jr * rstep + jj * inc];
    const int rr = min(max(i - vr + jr * inc, 0), Hr - 1);
    const int cc = min(max(j - hrad + jj * inc, 0), Wr - 1);
    return __ldg(g + ch * P + rr * Wr + cc);
  }
};

// The candidate's plane terms at one pixel.
struct Cand {
  float a, b, c0, inv_ax;
};

__device__ __forceinline__ Cand load_cand(const Args& p, int k, int pix) {
  const int P = p.Hr * p.Wr;
  Cand q;
  q.a = __ldg(p.abc + (3 * k + 0) * P + pix);
  q.b = __ldg(p.abc + (3 * k + 1) * P + pix);
  q.c0 = __ldg(p.abc + (3 * k + 2) * P + pix);
  const float s1 = 1.0f - q.a;
  q.inv_ax = 1.0f / (fabsf(s1) < 0.25f ? (s1 < 0.0f ? -0.25f : 0.25f) : s1);
  return q;
}

// The sampled columns of a window row and their products with the
// candidate's a (rounded on their own, as in the plain version), computed
// once per candidate for all T rows: xse[e] = j + x_ext0 + e inc (an
// integer, exact as a float) and ax[e] = a xse[e], e < n.
template <int MAXE>
struct RowCols {
  float xse[MAXE], ax[MAXE];
  __device__ __forceinline__ RowCols(const Cand& q, float xs0, float finc,
                                     int n) {
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      xse[e] = xs0 + (float)e * finc;
      ax[e] = e < n ? __fmul_rn(q.a, xse[e]) : 0.0f;
    }
  }
};

// Sample window row y = i + dy (fy: the same as a float) at the columns
// rc.xse[e], e < n: out[e][c].  The tap is floor(xx) from a round-down add
// of 2^23 (xx is in [0, W-1]), clamped to W-2 as an unsigned integer, so a
// NaN position reads a tap in range and keeps NaN in fx = xx - tap.
template <int C, int MAXE>
__device__ __forceinline__ void sample_row(const Args& p, const Cand& q,
                                           const RowCols<MAXE>& rc, int y,
                                           float fy, int n, float d_lo,
                                           float d_hi,
                                           float (&out)[MAXE][C]) {
  constexpr float kTwo23 = 8388608.0f;
  const int P = p.Hr * p.Wr;
  const int32_t* srow = p.src + min(max(y, 0), p.Hr - 1) * p.Wr;
  const float byc = __fadd_rn(__fmul_rn(q.b, fy), q.c0);
  const float wmax = (float)(p.Wr - 1);
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e >= n) break;
    const float disp = nclip(__fadd_rn(rc.ax[e], byc), d_lo, d_hi);
    const float xx = nclip(__fsub_rn(rc.xse[e], disp), 0.0f, wmax);
    const unsigned fl = (unsigned)(__float_as_int(__fadd_rd(xx, kTwo23)) -
                                   0x4B000000);
    const unsigned x0i = min(fl, (unsigned)(p.Wr - 2));
    const float fx = xx - (__int_as_float((int)x0i + 0x4B000000) - kTwo23);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int32_t wv = __ldg(srow + x0i + c * P);
      const float v0 = __int_as_float(wv & (int32_t)0xFFFF0000);
      const float v1 = __int_as_float((int32_t)((uint32_t)wv << 16));
      out[e][c] = v0 + fx * (v1 - v0);
    }
  }
}

// Bilateral weight of contribution (jr, jj).
template <int C, typename RW>
__device__ __forceinline__ float weight(const Args& p, const RW& rw,
                                        const float (&ref_c)[C], int jr,
                                        int jj) {
  float ws = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) ws = ws + fabsf(rw.at(c, jr, jj) - ref_c[c]);
  return ex2_ftz(ws * p.w_log2);
}

// One contribution: weight w times the truncated color + gradient
// differences of the reference window at (jr, jj) against the sample
// columns (e, elo, ehi) of the rows lo / cb / hi.
template <int C, typename RW>
__device__ __forceinline__ float contribution(
    const Args& p, const RW& rw, const Cand& q, int jr, int jj, float w,
    const float (&lo)[C], const float (&cbe)[C], const float (&cblo)[C],
    const float (&cbhi)[C], const float (&hi)[C], bool osx, bool osy) {
  float col = 0.0f, grd = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float gx_s = (cbhi[c] - cblo[c]) * q.inv_ax;
    if (osx) gx_s = gx_s + gx_s;
    float gy_d = hi[c] - lo[c];
    if (osy) gy_d = gy_d + gy_d;
    const float gy_s = gy_d + q.b * gx_s;
    col = col + fabsf(rw.at(c, jr, jj) - cbe[c]);
    grd = grd + (fabsf(rw.at(C + c, jr, jj) - gx_s) +
                 fabsf(rw.at(2 * C + c, jr, jj) - gy_s));
  }
  if (C > 1) col = col * p.inv_c;
  return w * (p.one_m_alpha * nmin(col, p.tau_col) +
              p.alpha * nmin(grd * p.grad_scale_c, p.tau_grad));
}

// ---- the unrolled kernel: square windows of the main path ----------------

template <int C, int T, bool ONESIDED, bool CACHEW, typename RW>
__device__ __forceinline__ void emit_fast(
    const Args& p, const RW& rw, const Cand& q,
    const float (&ref_c)[C], const float (&smp)[T][T][C],
    const float (&w)[T][T], int jr, float& acc) {
  constexpr int NC = ONESIDED ? T : T - 2;
  const int lo = ONESIDED ? (jr > 0 ? jr - 1 : 0) : jr;
  const int cb = ONESIDED ? jr : jr + 1;
  const int hi = ONESIDED ? (jr + 1 < T ? jr + 1 : T - 1) : jr + 2;
  const bool osy = ONESIDED && hi - lo == 1;
#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const int e = ONESIDED ? jj : jj + 1;
    const int elo = ONESIDED ? (jj > 0 ? jj - 1 : 0) : jj;
    const int ehi = ONESIDED ? (jj + 1 < NC ? jj + 1 : NC - 1) : jj + 2;
    const bool osx = ONESIDED && ehi - elo == 1;
    const float wt = CACHEW ? w[jr][jj] : weight<C>(p, rw, ref_c, jr, jj);
    acc = acc + contribution<C>(p, rw, q, jr, jj, wt, smp[lo][e],
                                smp[cb][e], smp[cb][elo], smp[cb][ehi],
                                smp[hi][e], osx, osy);
  }
}

// Contribution rows whose sample rows are all in once row u is sampled.
template <int C, int T, bool ONESIDED, bool CACHEW, typename RW>
__device__ __forceinline__ void emit_ready(
    const Args& p, const RW& rw, const Cand& q,
    const float (&ref_c)[C], const float (&smp)[T][T][C],
    const float (&w)[T][T], int u, float& acc) {
  if (ONESIDED) {
    if (u >= 1)
      emit_fast<C, T, ONESIDED, CACHEW>(p, rw, q, ref_c, smp, w, u - 1, acc);
    if (u == T - 1)
      emit_fast<C, T, ONESIDED, CACHEW>(p, rw, q, ref_c, smp, w, T - 1, acc);
  } else if (u >= 2) {
    emit_fast<C, T, ONESIDED, CACHEW>(p, rw, q, ref_c, smp, w, u - 2, acc);
  }
}

// T window rows at step INC, so the window radius VR (= hrad = vr), the
// shared tile's pitch and every offset into it are compile-time constants.
template <int C, int T, int INC, bool ONESIDED, bool CACHEW>
__global__ void __launch_bounds__(kThreads,
                                  C == 1 ? kMinBlocksNarrow : kMinBlocksWide)
sdg_fused_tile_kernel(const Args p) {
  extern __shared__ float sm[];
  constexpr int NR = ONESIDED ? T : T - 2;
  constexpr int VR = (NR - 1) * INC / 2;
  constexpr int PITCH = kTileW + 2 * VR;
  using RW = TileWin<INC * PITCH, INC>;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  if (!tile_on(p, blockIdx.y, blockIdx.x)) return;
  constexpr int rows_s = kTileH + 2 * VR;
  stage_ref<C>(p, sm, i0, j0, PITCH, rows_s);

  const int P = p.Hr * p.Wr;
  const int tj = threadIdx.x, j = j0 + tj;
  const float d_lo = __ldg(p.db), d_hi = __ldg(p.db + 1);
  // The first sampled row and column offset (the window is square).
  constexpr int ext0 = ONESIDED ? -VR : -VR - INC;
  const float xs0 = (float)(j + ext0);
  RW rw{nullptr, rows_s * PITCH};
  for (int ti = threadIdx.y; ti < kTileH; ti += blockDim.y) {
    const int i = i0 + ti;
    if (i >= p.Hr) break;
    const int pix = i * p.Wr + j;
    const float fy0 = (float)(i + ext0);
    rw.sm = sm + ti * PITCH + tj;
    float ref_c[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      ref_c[c] = rw.sm[c * rw.plane + VR * PITCH + VR];
    float w[T][T];
    if (CACHEW) {
#pragma unroll
      for (int jr = 0; jr < NR; ++jr)
#pragma unroll
        for (int jj = 0; jj < NR; ++jj)
          w[jr][jj] = weight<C>(p, rw, ref_c, jr, jj);
    }
    for (int k = 0; k < p.K; ++k) {
      const Cand q = load_cand(p, k, pix);
      const RowCols<T> rc(q, xs0, (float)INC, T);
      float smp[T][T][C];
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        sample_row<C, T>(p, q, rc, i + ext0 + t * INC,
                         fy0 + (float)(t * INC), T, d_lo, d_hi, smp[t]);
        // Emit one row late: row t's gathers overlap row t-1's emission.
        if (t >= 1)
          emit_ready<C, T, ONESIDED, CACHEW>(p, rw, q, ref_c, smp, w, t - 1,
                                             acc);
      }
      emit_ready<C, T, ONESIDED, CACHEW>(p, rw, q, ref_c, smp, w, T - 1,
                                         acc);
      p.out[k * P + pix] = (acc != acc || acc >= kMaxCost) ? kMaxCost : acc;
    }
  }
}

// ---- the generic kernel: any window with E <= MAXE ---------------------

// One window row's contributions from the rolling buffer rows lo / cb / hi.
template <int C, int MAXE, bool ONESIDED>
__device__ __forceinline__ float emit_row(
    const Args& p, const RefWin& rw, const Cand& q,
    const float (&ref_c)[C], const float (&lo)[MAXE][C],
    const float (&cb)[MAXE][C], const float (&hi)[MAXE][C], bool osy,
    int jr) {
  float acc = 0.0f;
#pragma unroll
  for (int jj = 0; jj < MAXE; ++jj) {
    if (jj >= p.NCOL) break;
    const int e = ONESIDED ? jj : jj + 1;
    const int elo = ONESIDED ? (jj > 0 ? jj - 1 : 0) : jj;
    // ehi is jj+1, or jj itself at the last one-sided column.
    const int ehi_c = ONESIDED ? (jj + 1 < MAXE ? jj + 1 : MAXE - 1) : jj + 2;
    const bool at_last = ONESIDED && (jj == p.NCOL - 1);
    const bool osx = ONESIDED && (jj == 0 || jj == p.NCOL - 1) && p.NCOL >= 2;
    const int ec = e < MAXE ? e : MAXE - 1;
    float chi[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      chi[c] = at_last ? cb[jj][c] : cb[ehi_c < MAXE ? ehi_c : MAXE - 1][c];
    const float wt = weight<C>(p, rw, ref_c, jr, jj);
    acc = acc + contribution<C>(p, rw, q, jr, jj, wt, lo[ec], cb[ec],
                                cb[elo], chi, hi[ec], osx, osy);
  }
  return acc;
}

template <int C, int MAXE, bool ONESIDED>
__global__ void __launch_bounds__(kThreads, kMinBlocksWide)
sdg_fused_generic_kernel(const Args p) {
  extern __shared__ float sm[];
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  if (!tile_on(p, blockIdx.y, blockIdx.x)) return;
  const int pitch = kTileW + 2 * p.hrad, rows_s = kTileH + 2 * p.vr;
  if (p.smem_ref) stage_ref<C>(p, sm, i0, j0, pitch, rows_s);

  const int P = p.Hr * p.Wr;
  const int tj = threadIdx.x, j = j0 + tj;
  const float d_lo = __ldg(p.db), d_hi = __ldg(p.db + 1);
  const int x_ext0 = ONESIDED ? -p.hrad : -p.hrad - p.inc;
  const int y_ext0 = ONESIDED ? -p.vr : -p.vr - p.inc;
  const float xs0 = (float)(j + x_ext0);
  RefWin rw{nullptr, p.ref, rows_s * pitch, p.inc * pitch, p.inc,
                  P, p.Hr, p.Wr, 0, j, p.vr, p.hrad};
  for (int ti = threadIdx.y; ti < kTileH; ti += blockDim.y) {
    const int i = i0 + ti;
    if (i >= p.Hr) break;
    const int pix = i * p.Wr + j;
    rw.i = i;
    if (p.smem_ref) rw.sm = sm + ti * pitch + tj;
    float ref_c[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      ref_c[c] = p.smem_ref ? rw.sm[c * rw.plane + p.vr * pitch + p.hrad]
                            : __ldg(p.ref + c * P + pix);
    for (int k = 0; k < p.K; ++k) {
      const Cand q = load_cand(p, k, pix);
      const RowCols<MAXE> rc(q, xs0, (float)p.inc, p.E);
      float prev2[MAXE][C], prev1[MAXE][C], cur[MAXE][C];
#pragma unroll
      for (int e = 0; e < MAXE; ++e)
#pragma unroll
        for (int c = 0; c < C; ++c) prev2[e][c] = prev1[e][c] = cur[e][c] = 0.f;
      float acc = 0.0f;
      for (int t = 0; t < p.T; ++t) {
        const int dy = y_ext0 + t * p.inc;
        sample_row<C, MAXE>(p, q, rc, i + dy, (float)(i + dy), p.E, d_lo,
                            d_hi, cur);
        // Emission schedule (pallas_sdg_fused.py _emits): contribution
        // rows that become computable once window row t is sampled.
        if (ONESIDED) {
          if (p.T == 1 && t == 0)
            acc = acc + emit_row<C, MAXE, ONESIDED>(p, rw, q, ref_c, cur, cur,
                                                    cur, false, 0);
          if (t == 1)
            acc = acc + emit_row<C, MAXE, ONESIDED>(p, rw, q, ref_c, prev1,
                                                    prev1, cur, true, 0);
          if (t >= 2)
            acc = acc + emit_row<C, MAXE, ONESIDED>(p, rw, q, ref_c, prev2,
                                                    prev1, cur, false, t - 1);
          if (t == p.T - 1 && p.T >= 2)
            acc = acc + emit_row<C, MAXE, ONESIDED>(p, rw, q, ref_c, prev1,
                                                    cur, cur, true, p.T - 1);
        } else if (t >= 2) {
          acc = acc + emit_row<C, MAXE, ONESIDED>(p, rw, q, ref_c, prev2,
                                                  prev1, cur, false, t - 2);
        }
#pragma unroll
        for (int e = 0; e < MAXE; ++e)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            prev2[e][c] = prev1[e][c];
            prev1[e][c] = cur[e][c];
          }
      }
      p.out[k * P + pix] = (acc != acc || acc >= kMaxCost) ? kMaxCost : acc;
    }
  }
}

// ---- launch -------------------------------------------------------------

// The current device, or -1 when it is not one kMaxDevices covers.
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// smem_set[dev]: the dynamic shared memory this kernel was last allowed on
// device dev (the attribute is per device).
template <typename Kern>
cudaError_t launch(Kern kern, const Args& p, int dev, size_t smem,
                   cudaStream_t s, size_t (&smem_set)[kMaxDevices]) {
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  dim3 block(kTileW, kThreadsY);
  dim3 grid(p.Wr / kTileW, (p.Hr + kTileH - 1) / kTileH);
  kern<<<grid, block, smem, s>>>(p);
  return cudaGetLastError();
}

template <int C, int T, int INC, bool ONESIDED>
cudaError_t launch_tile(const Args& p, int dev, size_t smem, cudaStream_t s) {
  static size_t set_w[kMaxDevices] = {}, set_n[kMaxDevices] = {};
  if (p.K > 1)
    return launch(sdg_fused_tile_kernel<C, T, INC, ONESIDED, true>, p, dev,
                  smem, s, set_w);
  return launch(sdg_fused_tile_kernel<C, T, INC, ONESIDED, false>, p, dev,
                smem, s, set_n);
}

// The main path's windows: box 11 / inc 2 (T=6), box 9 / inc 4 (T=3) and
// box 7 / inc 2 (T=4) one-sided, and the rows and step that give them with
// the extension ring.  Returns cudaErrorNotSupported for any other window.
template <int C, bool ONESIDED>
cudaError_t launch_tile_t(const Args& p, int dev, size_t smem,
                          cudaStream_t s) {
  const int nr = ONESIDED ? p.T : p.T - 2;
  if (p.vr != p.hrad || 2 * p.vr != (nr - 1) * p.inc)
    return cudaErrorNotSupported;
  if (p.T == 6 && p.inc == 2)
    return launch_tile<C, 6, 2, ONESIDED>(p, dev, smem, s);
  if (p.T == 3 && p.inc == 4)
    return launch_tile<C, 3, 4, ONESIDED>(p, dev, smem, s);
  if (p.T == 4 && p.inc == 2)
    return launch_tile<C, 4, 2, ONESIDED>(p, dev, smem, s);
  return cudaErrorNotSupported;
}

template <int C, int MAXE, bool ONESIDED>
cudaError_t launch_generic(const Args& p, int dev, size_t smem,
                           cudaStream_t s) {
  static size_t set[kMaxDevices] = {};
  return launch(sdg_fused_generic_kernel<C, MAXE, ONESIDED>, p, dev, smem, s,
                set);
}

template <int C>
cudaError_t launch_c(const Args& p, int maxe, bool onesided, cudaStream_t s) {
  // Opt-in shared memory per block of each device (0: not read yet).
  static int smem_max[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (smem_max[dev] == 0) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    smem_max[dev] = v;
  }
  const size_t smem = (size_t)3 * C * (kTileH + 2 * p.vr) *
                      (kTileW + 2 * p.hrad) * sizeof(float);
  Args q = p;
  q.smem_ref = smem <= (size_t)smem_max[dev];
  const bool square = p.E == p.T && p.NCOL == (onesided ? p.T : p.T - 2);
  if (q.smem_ref && square) {
    const cudaError_t e = onesided ? launch_tile_t<C, true>(q, dev, smem, s)
                                   : launch_tile_t<C, false>(q, dev, smem, s);
    if (e != cudaErrorNotSupported) return e;
  }
  const size_t gsmem = q.smem_ref ? smem : 0;
  switch (maxe) {
    case 4:
      return onesided ? launch_generic<C, 4, true>(q, dev, gsmem, s)
                      : launch_generic<C, 4, false>(q, dev, gsmem, s);
    case 8:
      return onesided ? launch_generic<C, 8, true>(q, dev, gsmem, s)
                      : launch_generic<C, 8, false>(q, dev, gsmem, s);
    case 16:
      return onesided ? launch_generic<C, 16, true>(q, dev, gsmem, s)
                      : launch_generic<C, 16, false>(q, dev, gsmem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gtt_sdg_fused_cost(
    const void* ref, const void* src, const void* abc, const void* db,
    const void* hwv, const void* tm, void* out, int C, int maxe, int K,
    int Hr, int Wr, int tm_w, int T, int E, int NCOL, int vr, int hrad,
    int inc, int onesided, float alpha, float one_m_alpha,
    float neg_inv_gamma_c, float inv_c, float tau_col, float tau_grad,
    float grad_scale_c, void* stream) {
  if (K <= 0 || Hr <= 0 || Wr <= 0) return 0;
  if (E > maxe || Wr % kTileW != 0) return (int)cudaErrorInvalidValue;
  Args p{(const float*)ref, (const int32_t*)src, (const float*)abc,
         (const float*)db, (const int32_t*)hwv, (const int32_t*)tm,
         (float*)out, K, Hr, Wr, tm_w, T, E, NCOL, vr, hrad, inc, 0, alpha,
         one_m_alpha, neg_inv_gamma_c * 1.4426950408889634f, inv_c,
         tau_col, tau_grad, grad_scale_c};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (C == 1)
    err = launch_c<1>(p, maxe, onesided != 0, s);
  else if (C == 3)
    err = launch_c<3>(p, maxe, onesided != 0, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
