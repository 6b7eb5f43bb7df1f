#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gipuma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py     # needs one CUDA device; exits non-zero
                              # without one, and prints no result

Phases, in order (any failure exits non-zero before the last line):

1. card name and power limit (nvidia-smi), torch.version.cuda, nvcc
   version, whether PIL imports;
2. build every CUDA kernel of the port from csrc/ (nvcc, one process per
   source, all started together);
3. kernel vs plain torch version on the card, at the main paths' shapes
   (inputs taken from the bench scene's rect and exact scenes and a
   random state): the nearest row gather bit-equal at masked-on
   coordinates (f32 and int32 words, with and without tile masks), on
   both passes of the forward and return permutations; the one-pass
   permute2d bit-equal to its plain version at consumed coordinates on
   the same permutations (and the plain one-pass to the two plain
   passes); the fused window cost within 1e-3 abs at covered pixels for K
   in {1, 4, R} at box 11 / inc 2 and at the cull box 9 / inc 4, on every
   tile (the image borders) and at C=3; the bilinear sampler
   bit-equal on view 0 at the propagation sweep's K=4 candidates x 36
   window offsets, some coordinates pushed 20 px outside the image; the
   lerp row gather bit-equal in its f32, PACKED and GFWD modes on view 0
   of the f32, full and gfwd scenes (K=4 candidates at the window corner),
   and the affine row gather bit-equal at the census path's largest row
   launch (K=4 x 11 columns), both with NaN positions and positions 20 px
   outside [0, W-1], and in its rows launches of the census path's sparse
   (K=4 x 9 rows x 9 columns) and full (K=1 x 11 x 11) passes against the
   stack of one-row plain calls;
4. fourteen paths on the 640x480, 7-camera bench scene, each driven through
   compute_depthmap with the kernel counts set to 0 just before and read
   just after, each held to a launch count > 0 for every kernel it runs
   (permute2d carries every permutation of the rect-family paths)
   and to finite depth, and all but gfwd and census to median relative
   depth error < 5e-3 on [16:-16, 16:-16]:
   (rect) the rect path at one pyramid level (two-stage cull,
   cull_view_stride 2), with write_outputs' seven artifacts;
   (exact) the exact cost path at one level, 8 iterations (the sampler);
   (pyramid) bench.py's default schedule: rect, 3 levels, fine-level
   trims, pyramid_coarse_box 7 (permute2d and the fused cost);
   (census_exact) census on the exact path, the census formula on the
   original grid (the sampler); (census) rect with -a ct, the CLI's
   `-a ct --cost_path rect` (the affine gather), held to 2.5x
   census_exact's error instead of 5e-3 (RELATIVE_GATES); (unfused) rect
   with fused_window_cost off (the affine gather); (full, gfwd, f32) the
   full-channel, grad_fwd and f32-tap rect layouts at 4 iterations (the
   lerp gather; gfwd prints its error only: gipuma_tpu/config.py records
   salt-noise failures of that layout at native sampling); (monolithic)
   rect at one level with propagation_variant="monolithic", the batch
   phase's run (d); (cull_downscale) the pyramid with cull_downscale=2
   (bench.py --cull_downscale 2), its launches split between the sparse
   passes on the nested grids, the sparse passes on full grids and the
   full passes; (rect_scan, pyramid_scan, exact_scan) rect, pyramid and
   exact with level_dispatch="scan" (each level one CUDA graph), the
   rect and exact ones with host syncs made errors inside the capture;
4c. (e) the nested cull scene of the cull_downscale pyramid's finest
   level: permute2d bit-equal to its plain version at consumed coordinates
   (forward K=4 f16 plane words, return f16 cost pairs) and the fused
   cost within 1e-3 at covered pixels (K=4, cull box 9 / inc 4) on every
   nested view; its grid's shape printed;
4d. (f) the scan paths' depth, normals and cost bit-equal to the host
   loop's from the same seed; a generator registered with a CUDA graph
   draws, on every replay, the next uniforms of its stream (those an
   eager call draws), not the captured ones again;
4e. (g) eval/parity on the card: run_preset_parity for middlebury and
   dtu_fast on the sos and noise textures (64x96, 3 iterations) and
   run_cull_hard_scene for its three kinds, held to the thresholds of the
   JAX package's tests/test_parity_presets.py and
   tests/test_cull_hard_scenes.py; one `parity` JSON line per row;
4f. (h) the native IO library (io/native.py) builds, and the rect path's
   .dmb and .ply bytes from it equal the numpy writer's;
4b. the batch phase, the scripts' path: a 16-camera ring at 640x480
   (Middlebury dinoSparseRing's view count and size) written to a
   temporary folder as 8-bit PNGs, one Middlebury par.txt and an
   analytic depth map per view (gt/depth_NNN.dmb), then
   (a) scripts/dino.sh's invocation through gipuma_tpu_torch.cli.main
   (--preset middlebury -blocksize 11 --iterations 8 --n_best 3
   --all_views --fuse --disp_thresh 0.1 --normal_thresh 30
   --num_consistent 3 -gt gt/depth_{idx:03d}.dmb; depth [3, 8], angles
   [0.01, 60] for this rig): the exact path, the sampler;
   (b) the same with --cost_path rect --pyramid_levels 3
   --pyramid_fine_iterations 1: permute2d and the fused cost;
   each held to: a launch count > 0 for every kernel it runs (counts set
   to 0 just before, read just after); every view's disp.dmb, read back
   from disk, finite with median relative depth error < 5e-3 on
   [16:-16, 16:-16] against its own analytic depth; each view's
   results.txt holding its gt_file and error_rate lines; fused.ply, read
   back, with >= 0.25*640*480 points at a median |n.X + d| / 5 < 5e-3
   against the plane; and in (a) the card's fuse_depthmaps of the 16
   maps against the port's CPU fuse_depthmaps: identical keep masks in
   the same order (each pixel's index passed as its colour), counts and
   median plane distances printed;
   (c) rect_quantize_shapes through run_batch on three reference views
   with different rect shapes: one shape bucket for all three
   (info["shape_bucket"]), each view < 5e-3, and the K=4 costs of one
   candidate set bit-equal between the quantized and the unquantized
   scene of one view;
   one `batch` JSON line per run: per-view runtime_s and error, the
   run's wall, fusion seconds on the card, points, peak allocated
   memory, kernel launches;
4g. (i) the parallel layer (gipuma_tpu_torch/parallel, fusion/sharded.py)
   on several ranks spawned by parallel/launch.py: with fewer cards than
   ranks all ranks share the card over gloo (NCCL refuses a device twice;
   printed), with a card per rank NCCL.  Every sub-run is held to a
   launch count > 0 on every rank for each kernel it runs, finite depth
   and median relative depth error < 5e-3 on [16:-16, 16:-16]:
   (i1) view-sharded rect on the bench scene (middlebury widths, 8
   iterations, no two-stage cull: the sharded path runs none), 3 ranks of
   2 views, against the port's single-process run from the same seed:
   cost within 1e-5, planes within 1e-4 (tests/test_rect_sharding.py);
   (i2) view-sharded exact, 2 ranks, the same check; (i3) tile x view
   rect 2 x 2 (scripts/multichip_realistic.py's layout on 4 ranks), with
   the band-seam rows' median error < 1e-2 (tests/test_tiled_rect.py:51);
   (i4) tiled exact, propagation only, 2 bands against one process
   within 1e-6 (tests/test_tiled.py); (i5) the CLI's --distributed with
   scripts/dino.sh's flags over the batch phase's folder on 2 ranks: each
   view's disp.dmb against run (a)'s (differences reported), fused.ply
   with run (a)'s point count and points within 1e-5, and the sharded
   fusion of run (a)'s maps in the same world keeping the card fusion's
   pixels in its order, its seconds beside run (a)'s fusion's.  One
   `dist` JSON line per sub-run: walls, collective calls and bytes (per
   iteration), host copies, peak memory, launches; and from a profiled
   repeat of each sub-run but (i5)'s CLI, per-rank device seconds and the
   collectives' seconds (NCCL's kernels on the card, gloo's spans on the
   host);
5. timings, one JSON line each: each path's warm run wall time (after a
   full garbage collection outside the timed span; with the collector's
   seconds inside it, the caching allocator's new device allocations and
   retries, the reserved memory and the live threads in that run), and a
   profiled run's device busy share and device time by kernel; each
   kernel's, its plain version's and the library call's device time per
   call (CUDA-graph replay between CUDA events, so host dispatch is
   outside the span) beside its bound (permute2d also beside the
   two-pass chain it replaced; the fused cost at the full pass's K=1
   and the cull pass's K=4 shapes; the affine gather at one row and at
   the census path's rows launches, beside its path-level bound per
   launch, counted by its wrapper from each launch's shape; the exact PM
   window sum at both benchmark cells' unit shapes, held to 1e-4 of its
   plain version there: exact_cost_lines; its warp prologue at the same
   units, held bit-equal to warped_coords: exact_warp_lines); each path's
   line also holds its peak allocated memory and, for the scan paths, the
   CUDA graph's capture seconds and replays per level; a `cull_downscale`
   line beside the pyramid and a `scan_vs_host` line per scan path;
6. the `kernels` JSON line, the card line, and the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
# FP32 operations the fused cost needs, counted from its plain version's
# arithmetic (ops/sdg_fused.window_grads_cost and the sampler above it);
# a subtraction, product, sum, min / max bound or exp counts one, an
# absolute value (a free operand modifier on the card) and a select none.
# Per candidate and pixel: each of the T*E sample positions a*x + (b*y +
# c), two clips, a subtraction, the tap's floor and fraction (8), with a*x
# once per column (1) and b*y + c once per row (2); per channel sample the
# lerp v0 + fx (v1 - v0) (3); the Jacobian 1 / (1 - a) (2).  Per
# contribution: per channel gx (2), gy (3), the colour term (2) and the
# two gradient terms (4), less the first of the C-channel sums (2); then
# the 1/C mean (C > 1), two truncations, the gradient scale, the alpha
# blend (3), the weight and the sum (8).  Per pixel, once for all K: each
# of the NROW*NCOL bilateral weights, C differences summed, a scale and
# one exp (2C + 1).
OPS_POSITION = 8
OPS_COLUMN = 1
OPS_ROW = 2
OPS_LERP_C = 3
OPS_CANDIDATE = 2
OPS_CONTRIB_C = 11
OPS_CONTRIB = 6
OPS_WEIGHT_C = 2
OPS_WEIGHT = 1

# Port kernel -> the symbol (a prefix) of its __global__ functions.
KERNEL_SYMBOLS = {"row_gather_nearest": "row_gather_nearest_kernel",
                  "sdg_fused_cost": "sdg_fused_",
                  "bilinear_sample": "bilinear_sample_kernel",
                  "row_gather_lerp": "row_gather_lerp_kernel",
                  "row_gather_affine": "row_gather_affine_kernel",
                  "permute2d": "permute2d_kernel",
                  "exact_window_cost": "exact_window_cost_kernel",
                  "exact_warp_coords": "exact_warp_coords_kernel"}
# The kernels each path runs.
PATH_KERNELS = {"rect": ("permute2d", "sdg_fused_cost"),
                "exact": ("bilinear_sample", "exact_window_cost",
                          "exact_warp_coords"),
                "pyramid": ("permute2d", "sdg_fused_cost"),
                "census_exact": ("bilinear_sample",),
                "census": ("permute2d", "row_gather_affine"),
                "unfused": ("permute2d", "row_gather_affine"),
                "full": ("permute2d", "row_gather_lerp"),
                "gfwd": ("permute2d", "row_gather_lerp"),
                "f32": ("permute2d", "row_gather_lerp"),
                "monolithic": ("permute2d", "sdg_fused_cost"),
                "cull_downscale": ("permute2d", "sdg_fused_cost"),
                "rect_scan": ("permute2d", "sdg_fused_cost"),
                "pyramid_scan": ("permute2d", "sdg_fused_cost"),
                "exact_scan": ("bilinear_sample", "exact_window_cost",
                               "exact_warp_coords")}
# The share of the sampler's launches that take a tile (csrc/sampling.cu):
# every PM unit (B = candidates x 36 offsets), CENSUS's window but not its
# centre sample (B = the candidates).
SAMPLER_TILED_SHARE = {"exact": 1.0, "exact_scan": 1.0, "census_exact": 0.5}
# level_dispatch="scan" paths -> the host-loop path each must equal.
SCAN_PATHS = {"rect_scan": "rect", "pyramid_scan": "pyramid",
              "exact_scan": "exact"}
# Paths whose median error is printed but not gated: grad_fwd's in-cell
# gradient is out of phase at native sampling (gipuma_tpu/config.py).
UNGATED = ("gfwd",)
# Paths held to a multiple of another path's median error instead of 5e-3:
# the rect census against the census formula on the original grid (the
# exact path's census, run just before it).  On this pixel-noise scene the
# rect census resamples both images and misses 5e-3 while the exact
# census makes it (PERF.md, Findings); the multiple catches a fault of the
# port's rect census without holding the layout to what it cannot reach.
RELATIVE_GATES = {"census": ("census_exact", 2.5)}
# Iterations of the full, gfwd and f32 layouts (one lerp launch per window
# offset, view and evaluation: the slowest paths of the script).
LAYOUT_ITERATIONS = 4


_T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(what: str) -> None:
    """A phase line with the seconds since the script started."""
    log(f"[{time.perf_counter() - _T0:.1f} s] {what}")


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - report, do not hide
        return f"nvidia-smi unavailable ({e})"


def nvcc_version() -> str:
    from gipuma_tpu_torch import kernels
    out = subprocess.run([kernels.nvcc_path(), "--version"],
                         capture_output=True, text=True, timeout=60)
    lines = [ln for ln in out.stdout.splitlines() if "release" in ln]
    return lines[0].strip() if lines else out.stdout.strip()


def scene_setup():
    """The bench scene and the paths' configurations: bench.py's (rect,
    two-stage cull, cull_view_stride 2) at one pyramid level (`--schedule
    reference`), the same on the exact cost path, bench.py's default
    3-level pyramid, and the rect path's other costs and layouts: census,
    the unfused window_grads cost, full channels, grad_fwd and f32 taps.
    Depth range [3, 8] and angles [0.01, 60] keep all six source views."""
    from gipuma_tpu_torch.config import PRESETS, MatchingAlgorithm
    from gipuma_tpu_torch.utils.synthetic import make_ring_P, plane_scene
    n, h, w, f = 7, 480, 640, 800.0
    images, rig, gt, _ = plane_scene(num_cams=n, h=h, w=w, focal=f,
                                     plane_depth=5.0, slant=(0.2, -0.1),
                                     texture="noise")
    Ps = make_ring_P(n, h, w, f, target_depth=5.0)
    base = PRESETS["middlebury"].replace(
        seed=0, depth_min=3.0, depth_max=8.0, min_angle=0.01,
        max_angle=60.0)
    rect = base.replace(cost_path="rect", pyramid_levels=1,
                        rect_two_stage_cull=True, cull_view_stride=2)
    paths = {
        "rect": rect,
        "exact": base.replace(cost_path="exact", pyramid_levels=1),
        "pyramid": rect.replace(
            pyramid_levels=3, pyramid_fine_iterations=1,
            pyramid_fine_far=False, pyramid_fine_refine_rounds=2,
            pyramid_carry_cost=True, pyramid_coarse_box=7),
        # The census cost's reference formula on the original grid: what
        # the rect census is compared with.
        "census_exact": base.replace(cost_path="exact", pyramid_levels=1,
                                     algorithm=MatchingAlgorithm.CENSUS),
        "census": rect.replace(algorithm=MatchingAlgorithm.CENSUS),
        "unfused": rect.replace(fused_window_cost=False),
        "full": rect.replace(window_grads=False,
                             iterations=LAYOUT_ITERATIONS),
        "gfwd": rect.replace(window_grads=False, grad_fwd_pack=True,
                             iterations=LAYOUT_ITERATIONS),
        "f32": rect.replace(pack_taps=False, iterations=LAYOUT_ITERATIONS),
        # The reference's gipuma_checkerboard_cu schedule: one sweep over
        # 20 neighbour offsets per parity (batch phase, run (d)).
        "monolithic": rect.replace(propagation_variant="monolithic"),
    }
    # bench.py --cull_downscale 2 on its default pyramid (bench.py:126-131,
    # 156-157), and --dispatch scan on rect (--schedule reference), the
    # pyramid and the exact path.
    paths["cull_downscale"] = paths["pyramid"].replace(cull_downscale=2)
    for label, host in SCAN_PATHS.items():
        paths[label] = paths[host].replace(level_dispatch="scan")
    return images, rig, gt, Ps, paths


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call of `fn`, in ms: `reps` calls captured in one
    CUDA graph, the graph replayed `rounds` times between CUDA events, the
    median per call.  Host dispatch (Python, the wrappers' checks, ctypes)
    stays outside the timed span."""
    torch = sys.modules["torch"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(per)


def bit_equal(got, want, what, name):
    """Bit-equality of two float32 tensors, NaN at the same places.
    Returns the largest |difference| of the finite values (0 = equal)."""
    torch = sys.modules["torch"]
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = bool(torch.equal(nan_g, nan_w)) and bool(torch.equal(
        got.nan_to_num(-1.0).view(torch.int32),
        want.nan_to_num(-1.0).view(torch.int32)))
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want).abs()[fin].max()) if bool(fin.any()) else 0.0
    log(f"  {what}: {got.numel()} values ({int(nan_w.sum())} NaN), "
        f"{'bit-equal' if same else 'DIFFER'}, max |diff| {err:.3g}")
    if not same:
        fail(f"{name} differs from its plain version: {what}")
    return err


def masked_equal(got, want, tile_ok, what, name="row_gather_nearest"):
    """Bit-equality of two [B, C, H, Ws] 32-bit tensors on the pixels of
    masked-on [8, 128] tiles (all pixels without a mask)."""
    torch = sys.modules["torch"]
    g = got.contiguous().view(torch.int32)
    w = want.contiguous().view(torch.int32)
    if tile_ok is not None:
        H, Ws = g.shape[-2:]
        on = tile_ok.to(torch.bool).repeat_interleave(8, 0)
        on = on.repeat_interleave(128, 1)[:H, :Ws]
        g, w = g[..., on], w[..., on]
    bad = int((g != w).sum())
    # Largest difference of the 32-bit words read as integers (0 = equal).
    err = float((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
        if g.numel() else 0.0
    log(f"  {what}: {g.numel()} words compared, {bad} differ")
    if bad:
        fail(f"{name} differs from its plain version: {what}")
    return err


def profile_path(torch, job, card, run_s, label):
    """One more run of a path under torch.profiler, recording the device's
    activity only: device time by kernel name, and the device's busy share
    of an unprofiled run's wall time `run_s` (the profiler's own overhead
    stretches the profiled wall, so that share is printed too but not
    used).  The device events are summed straight from the profiler's raw
    events: key_averages() post-processes every event in Python, minutes
    for a run of 10^5 launches.  Returns {port kernel: (device ms,
    launches)} of that run, the wrappers' tallies of it ({kernel:
    (launches, bytes moved)} for the kernels whose wrappers sum bytes) and
    {"device_s", "busy_share"} of the run against `run_s`."""
    from torch.profiler import ProfilerActivity, profile
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.pipeline import run_prepared_job
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_prepared_job(job)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = {k: (kernels.counts[k], b) for k, b in kernels.bytes_moved.items()}
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        # Device-side events only (kernels, memcpy/memset).
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        us = ev.duration_ns() / 1e3
        if us > 0:
            tot, n = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (tot + us, n + 1)
    rows = sorted(((us, k, c) for k, (us, c) in by_name.items()),
                  reverse=True)
    dev_total = sum(us for us, _, _ in rows)
    port = {}
    for name in PATH_KERNELS[label]:
        hit = [(us, c) for us, k, c in rows if KERNEL_SYMBOLS[name] in k]
        port[name] = (sum(us for us, _ in hit) / 1e3,
                      sum(c for _, c in hit))
    if dev_total <= 0:
        log(json.dumps({"metric": "path_profile", "path": label,
                        "card": card, "device_time": "not measured"}))
        return {}, moved, {"device_s": "not measured",
                           "busy_share": "not measured"}
    log(json.dumps({
        "metric": "path_profile", "path": label, "card": card,
        "wall_s_profiled": wall, "device_s": dev_total / 1e6,
        "device_launches": sum(c for _, _, c in rows),
        "busy_share_of_profiled_wall": dev_total / 1e6 / wall,
        "busy_share_of_unprofiled_run": dev_total / 1e6 / run_s,
        "port_kernels": {k: {"device_ms": ms, "launches": n}
                         for k, (ms, n) in port.items()},
        "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": c}
                for us, k, c in rows[:12]]}))
    return port, moved, {"device_s": dev_total / 1e6,
                         "busy_share": dev_total / 1e6 / run_s}


def bench_inputs(torch, scene, jparams, device, v0: int = 0):
    """View v0's kernel inputs from a random state of the rect scene:
    m_words(K, pack, sc) is the forward permutation's input of K
    candidates (parity 0 active pixels, the state's plane jittered per
    candidate; [CH, S, S], rotated and padded as the cost path does) and
    abc_of(K, pack, sc) their affine disparity fields on the rect grid,
    [K, 3, Hr, Wr], through the forward permutation."""
    from gipuma_tpu_torch.models.patchmatch import init_state, make_generator
    from gipuma_tpu_torch.ops import checkerboard as cb
    from gipuma_tpu_torch.ops import rect_cost as rc
    from gipuma_tpu_torch.ops.permute2d import permute2d

    def zero_cost(s, p, par, n, d):
        return torch.zeros(n.shape[:2], device=device)

    with torch.no_grad():
        st = init_state(scene, jparams, make_generator(0, device),
                        cost_fn=zero_cost)
    h, w = st.cost.shape
    n_full = st.planes[..., :3]
    d_full = st.planes[..., 3]

    def m_words(K, pack, sc=scene):
        n0 = cb.extract(n_full, 0)
        d0 = cb.extract(d_full, 0)
        g2 = make_generator(K, device)
        jit = 1.0 + 0.01 * torch.randn((K,) + d0.shape, generator=g2,
                                       device=device)
        n = n0[None].expand(K, *n0.shape).contiguous()
        d = d0[None] * jit
        m = n / d[..., None]
        m_chw = torch.repeat_interleave(m, 2, dim=2).permute(0, 3, 1, 2)
        if pack == "pair":
            m_ch = rc._pack_m(m_chw).reshape(2 * K, h, w)
        elif pack == "tri":
            m_ch = rc._pack_m_tri(m_chw)
        else:
            m_ch = m_chw.reshape(3 * K, h, w)
        rk = torch.rot90(m_ch, sc.rotations()[v0], dims=(-2, -1))
        s_sq = sc.fwd_c1.shape[-2]
        out = rk.new_zeros((rk.shape[0], s_sq, s_sq))
        out[:, :rk.shape[-2], :rk.shape[-1]] = rk
        return out.contiguous()

    def abc_of(K, pack, sc=scene):
        mp = m_words(K, pack, sc)
        m_rect = permute2d(mp, sc.fwd_c1[v0], sc.fwd_r[v0])
        hh, ww = sc.ref_rect.shape[-2:]
        if pack == "pair":
            m_rect = rc._unpack_m(m_rect.reshape(K, 2, hh, ww))
        else:
            m_rect = rc._unpack_m_tri(m_rect, K)
        return rc._apply_L(sc.L[v0], m_rect).contiguous()

    return m_words, abc_of


def fused_bound(p, K: int, C: int, npx: int):
    """(ms, bound_by, operations, bytes) of the fused cost of K candidates
    over npx covered pixels: the FP32 operations of the OPS_* count above
    at the FP32 peak, against abc (3K), the reference (3C), the source (C)
    and the output (K) words, each once, at the HBM rate."""
    from gipuma_tpu_torch.ops.sdg_fused import window_geometry
    xs_off, rows_c, xs_ext, ys_ext = window_geometry(p)
    T, E, n_contrib = len(ys_ext), len(xs_ext), len(rows_c) * len(xs_off)
    per_cand = (T * E * (OPS_POSITION + OPS_LERP_C * C) + E * OPS_COLUMN
                + T * OPS_ROW + OPS_CANDIDATE
                + n_contrib * (OPS_CONTRIB_C * C + OPS_CONTRIB + (C > 1)))
    per_px = K * per_cand + n_contrib * (OPS_WEIGHT_C * C + OPS_WEIGHT)
    ops = npx * per_px
    nbytes = npx * 4 * (3 * K + 3 * C + C + K)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", ops, nbytes)


def pass1_mask(torch, r, mask2, in_h):
    """The first gather pass's tile mask of the two-pass chain that
    permute2d replaced: tile (row block, 128-lane group) of its [in_h,
    out_w] output is on iff an output on mask2's tiles reads a row in it
    (the row-gather kernel's masked cases and the chain's timing)."""
    from gipuma_tpu_torch.ops.permute2d import _nearest
    out_h, out_w = r.shape
    on = mask2.to(torch.bool).repeat_interleave(8, 0).repeat_interleave(
        128, 1)[:out_w, :out_h].t()
    rows = _nearest(r, in_h)[on]
    lanes = torch.arange(out_w, device=r.device).expand(out_h, out_w)[on]
    m1 = torch.zeros((-(-in_h // 8), -(-out_w // 128)), dtype=torch.int32,
                     device=r.device)
    m1[rows // 8, lanes // 128] = 1
    return m1


def permute_bound(torch, x, c1, r, mask2):
    """(ms, bytes) the one-pass permutation must move for these inputs: R
    and the output words of the consumed outputs (those on mask2's tiles,
    all without it), and the distinct C1 entries and source words they
    read, each once, at the HBM rate."""
    from gipuma_tpu_torch.ops.permute2d import permute2d_index
    C, in_h, in_w = x.shape
    out_h, out_w = r.shape
    on = torch.ones((out_h, out_w), dtype=torch.bool, device=r.device)
    if mask2 is not None:
        on = mask2.to(torch.bool).repeat_interleave(8, 0).repeat_interleave(
            128, 1)[:out_w, :out_h].t()
    flat = permute2d_index(c1, r, in_h, in_w)[on]
    lanes = torch.arange(out_w, device=r.device).expand(out_h, out_w)[on]
    n_on = int(on.sum())
    n_c1 = int(torch.unique((flat // in_w) * out_w + lanes).numel())
    n_src = int(torch.unique(flat).numel())
    nbytes = 4 * (n_on + n_c1 + C * n_src + C * n_on)
    return nbytes / HBM_BPS * 1e3, nbytes

def run_split(torch, params, images, Ps, device):
    """compute_depthmap as prepare_job + run_prepared_job, with each
    rect_per_view_costs_batch call's launches attributed to its pass: the
    sparse passes on nested (cull_downscale) grids, the sparse passes on
    full-resolution grids (the coarse level screens there) and the full
    passes.  The attribution changes no launch.  Returns (result, {pass:
    {kernel: launches}})."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.ops import rect_cost as rc
    from gipuma_tpu_torch.pipeline import prepare_job, run_prepared_job
    job = prepare_job(images, Ps, params, device=device)
    inner = rc.rect_per_view_costs_batch
    split = {}

    def attributed(scene, p, parity, n, d, m_pack=None, cost_pack=False,
                   extra_mask=None):
        before = dict(kernels.counts)
        out = inner(scene, p, parity, n, d, m_pack=m_pack,
                    cost_pack=cost_pack, extra_mask=extra_mask)
        if m_pack != "tri":
            key = "full"
        elif any(scene is f.result()[0].cull for f in job.prep):
            key = "sparse_nested"
        else:
            key = "sparse_full_grid"
        tally = split.setdefault(key, {})
        for k, v in kernels.counts.items():
            if v > before[k]:
                tally[k] = tally.get(k, 0) + v - before[k]
        return out

    rc.rect_per_view_costs_batch = attributed
    try:
        res = run_prepared_job(job)
    finally:
        rc.rect_per_view_costs_batch = inner
    return res, split


def nested_kernel_checks(torch, job, device):
    """(e): permute2d and the fused cost against their plain versions on
    every view of the nested cull scene of the cull_downscale pyramid's
    finest level (K=4 candidates, as the sparse pass launches them).
    Returns (max permute error, max fused error, the nested scene, its
    level params, the fused case of view 0 for timing)."""
    from gipuma_tpu_torch.ops import rect_cost as rc
    from gipuma_tpu_torch.ops.permute2d import permute2d_cuda, permute2d_plain
    from gipuma_tpu_torch.ops.sdg_fused import (fused_sdg_cost_batch_cuda,
                                                fused_sdg_cost_batch_plain)
    scene, _, p_l, _ = job.prep[-1].result()
    sc = scene.cull
    if sc is None:
        fail("cull_downscale: the finest level has no nested cull scene")
    sp = p_l.replace(box_hsize=p_l.cull_box, box_vsize=p_l.cull_box,
                     window_increment=p_l.cull_increment)
    hr, wr = sc.ref_rect.shape[-2:]
    log(f"  nested cull scene: {sc.num_views} views, rect "
        f"{tuple(sc.ref_rect.shape)} (full {tuple(scene.ref_rect.shape)}), "
        f"S {sc.fwd_c1.shape[-2]}, rot {sc.rotations()}")
    err_p = err_f = 0.0
    timing = None
    for v, ok in enumerate(sc.valid_views()):
        if not ok:
            continue
        m_words, abc_of = bench_inputs(torch, sc, p_l, device, v)
        x = m_words(4, "tri")
        for what, src, c1, r, m2 in (
                ("fwd K=4 tri", x, sc.fwd_c1[v], sc.fwd_r[v], sc.fwd2_ok[v]),):
            want = permute2d_plain(src, c1, r)
            got = permute2d_cuda(src, c1, r, m2)
            err_p = max(err_p, masked_equal(
                got.transpose(1, 2)[None], want.transpose(1, 2)[None], m2,
                f"nested view {v}: {what} {tuple(src.shape)}->"
                f"{tuple(got.shape)}", "permute2d"))
        abc = abc_of(4, "tri")
        db = sc.disp_bounds[v].contiguous()
        hw = sc.hw_valid[v].contiguous()
        tm = sc.tile_ok[v].contiguous()
        want = fused_sdg_cost_batch_plain(sc.ref_rect[v], sc.src_rect[v],
                                          abc, sp, db[0], db[1])
        got = fused_sdg_cost_batch_cuda(sc.ref_rect[v], sc.src_rect[v], abc,
                                        sp, db, hw, tm)
        cov = tm.to(torch.bool).repeat_interleave(8, 0).repeat_interleave(
            128, 1)[:hr, :wr].clone()
        hv, wv = (int(a) for a in hw.tolist())
        cov[(hv + 7) // 8 * 8:] = False
        cov[:, (wv + 127) // 128 * 128:] = False
        diff = (got - want).abs()[:, cov]
        e = float(diff.max()) if diff.numel() else 0.0
        err_f = max(err_f, e)
        log(f"  nested view {v}: fused K=4 cull box {sp.box_hsize}/inc "
            f"{sp.window_increment}: {int(cov.sum())} covered px, max "
            f"|diff| {e:.3g}")
        if not e <= 1e-3:
            fail(f"sdg_fused_cost differs from its plain version on the "
                 f"nested cull scene, view {v}: {e}")
        cw = rc._pack_f16_pairs(want).contiguous()
        r2 = sc.ret2_ok[v]
        want_r = permute2d_plain(cw, sc.ret_c1[v], sc.ret_r[v])
        got_r = permute2d_cuda(cw, sc.ret_c1[v], sc.ret_r[v], r2)
        err_p = max(err_p, masked_equal(
            got_r.transpose(1, 2)[None], want_r.transpose(1, 2)[None], r2,
            f"nested view {v}: ret f16 pairs {tuple(cw.shape)}->"
            f"{tuple(got_r.shape)}", "permute2d"))
        if timing is None:
            timing = (sc.ref_rect[v], sc.src_rect[v], abc, sp, db, hw, tm,
                      int(cov.sum()))
    return err_p, err_f, sc, timing


def alternate(torch, job_a, job_b, rounds: int = 2):
    """Warm runs of two prepared jobs in turns (a, b, b, a each round), a
    full garbage collection before each; returns their runtime_s lists."""
    from gipuma_tpu_torch.pipeline import run_prepared_job
    out = ([], [])
    for _ in range(rounds):
        for i in (0, 1, 1, 0):
            gc.collect()
            torch.cuda.synchronize()
            out[i].append(run_prepared_job((job_a, job_b)[i]).runtime_s)
    return out


def preset_gate(r) -> list:
    """tests/test_parity_presets.py's thresholds; the ones a row misses."""
    checks = [
        (r["exact"]["median"] < 8e-3, "exact median < 8e-3"),
        (r["rect"]["median"] < 8e-3, "rect median < 8e-3"),
        (r["rect"]["median"] < 2.0 * max(r["exact"]["median"], 2e-3),
         "rect median < 2 x max(exact, 2e-3)"),
        (r["gap"]["median"] < 1.2e-2, "gap median < 1.2e-2"),
        (r["rect"]["valid_frac"] > 0.95, "rect valid_frac > 0.95"),
        (r["rect_normals"]["median_deg"] < 1.5 * max(
            r["exact_normals"]["median_deg"], 6.0),
         "rect normals < 1.5 x max(exact normals, 6 deg)")]
    return [what for ok, what in checks if not ok]


def hard_scene_gate(r) -> list:
    """tests/test_cull_hard_scenes.py's thresholds; the ones a row
    misses."""
    def same_class(cull, plain, med_cap=5e-3, p99_factor=2.5):
        return (cull["median"] < max(2.0 * plain["median"], med_cap)
                and cull["p99"] < max(p99_factor * plain["p99"],
                                      10 * med_cap))
    if r["kind"] == "two_plane":
        checks = [(same_class(r["cull"], r["plain"]), "overall"),
                  (same_class(r["cull_region"], r["plain_region"],
                              p99_factor=3.0), "discontinuity band")]
    elif r["kind"] == "textureless_patch":
        checks = [(same_class(r["cull_outside"], r["plain_outside"]),
                   "textured surround")]
    else:
        checks = [(same_class(r["cull"], r["plain"]), "overall")]
    return [what for ok, what in checks if not ok]


def parity_phase(device, card):
    """(g): the parity harness on the card, held to the JAX tests'
    thresholds."""
    from gipuma_tpu_torch.eval.parity import (run_cull_hard_scene,
                                              run_preset_parity)
    rows = []
    for preset, tex in (("middlebury", "sos"), ("dtu_fast", "sos"),
                        ("middlebury", "noise"), ("dtu_fast", "noise")):
        t0 = time.perf_counter()
        r = run_preset_parity(preset, 64, 96, iterations=3, border=10,
                              texture=tex, device=device)
        bad = preset_gate(r)
        log(json.dumps({"metric": "parity", "card": card, "row": r,
                        "s": time.perf_counter() - t0, "misses": bad}))
        if bad:
            fail(f"parity {preset}/{tex}: misses {bad}")
        rows.append(r)
    for kind in ("two_plane", "textureless_patch", "low_contrast"):
        t0 = time.perf_counter()
        r = run_cull_hard_scene(kind, device=device)
        bad = hard_scene_gate(r)
        log(json.dumps({"metric": "parity_hard_scene", "card": card,
                        "row": r, "s": time.perf_counter() - t0,
                        "misses": bad}))
        if bad:
            fail(f"hard scene {kind}: misses {bad}")
        rows.append(r)
    return rows


def native_io_phase(np, res, image, P):
    """(h): the native IO library builds, and the .dmb / .ply bytes it
    writes equal the numpy writer's (the native library switched off for
    the second write); the native reader reads them back."""
    from gipuma_tpu_torch.io import dmb, native, ply
    if not native.available():
        fail("native IO: the library did not build (g++)")
    out = {}
    with tempfile.TemporaryDirectory() as td:
        def write_all(tag):
            dmb.write_dmb(os.path.join(td, f"{tag}_disp.dmb"), res.depth)
            dmb.write_dmb(os.path.join(td, f"{tag}_normals.dmb"),
                          res.normals)
            n = ply.write_ply(os.path.join(td, f"{tag}.ply"), res.depth,
                              res.normals, image, P)
            return n
        n_native = write_all("native")
        lib, tried = native._lib, native._lib_tried
        native._lib, native._lib_tried = None, True
        try:
            n_numpy = write_all("numpy")
        finally:
            native._lib, native._lib_tried = lib, tried
        for name in ("disp.dmb", "normals.dmb", ".ply"):
            a = open(os.path.join(td, f"native{'_' if name[0] != '.' else ''}"
                                  f"{name}"), "rb").read()
            b = open(os.path.join(td, f"numpy{'_' if name[0] != '.' else ''}"
                                  f"{name}"), "rb").read()
            out[name] = len(a)
            if a != b:
                fail(f"native IO: {name} bytes differ from the numpy "
                     f"writer's ({len(a)} vs {len(b)} bytes)")
        back = native.read_dmb_native(os.path.join(td, "native_normals.dmb"))
        if back is None or not np.array_equal(back, res.normals):
            fail("native IO: the native reader did not read the normals back")
    log(f"  native IO: library {native._lib_path().name}, bytes equal "
        f"{out}, {n_native} points (numpy {n_numpy})")
    return out



# The batch phase's folder: Middlebury dinoSparseRing's view count and
# image size (scripts/dino_sparse_ring.sh), the bench scene's plane.
BATCH_VIEWS, BATCH_H, BATCH_W, BATCH_F = 16, 480, 640, 800.0
# scripts/dino.sh's invocation; only the depth range and the angles are
# this scene's.
DINO_FLAGS = ["--preset", "middlebury", "-blocksize", "11",
              "--iterations", "8", "--n_best", "3", "--all_views",
              "--skip_existing", "--fuse", "--disp_thresh", "0.1",
              "--normal_thresh", "30", "--num_consistent", "3",
              "--depth_min", "3", "--depth_max", "8", "--min_angle", "0.01",
              "--max_angle", "60"]
# Run (c)'s reference views: three rect shapes; the first has the largest
# bucket of the three, so the ledger holds all three at one bucket (a scan
# that meets a larger view later ratchets up from there).
QUANT_REFS = (1, 5, 13)


def write_batch_folder(np, root: str):
    """Render the 16-camera ring into `root`: 8-bit PNGs (the port's
    save_png), one Middlebury par.txt ("name K R t" per view, the count
    first) and the analytic depth of every view as gt/depth_NNN.dmb.
    Returns (image names, the plane (n, d))."""
    from gipuma_tpu_torch.geometry.camera import decompose_projection
    from gipuma_tpu_torch.io.dmb import write_dmb
    from gipuma_tpu_torch.io.vis import save_png
    from gipuma_tpu_torch.utils.synthetic import (intersect_plane,
                                                  make_ring_P, plane_scene)
    images, _, _, (n_w, d_w) = plane_scene(
        num_cams=BATCH_VIEWS, h=BATCH_H, w=BATCH_W, focal=BATCH_F,
        plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(BATCH_VIEWS, BATCH_H, BATCH_W, BATCH_F,
                     target_depth=5.0)
    os.makedirs(os.path.join(root, "gt"))
    names, lines = [], [str(BATCH_VIEWS)]
    for i, (im, P) in enumerate(zip(images, Ps)):
        name = f"view{i:03d}.png"
        save_png(os.path.join(root, name),
                 np.clip(np.round(im), 0, 255).astype(np.uint8))
        K, R, C = decompose_projection(P)
        krt = np.concatenate([K.ravel(), R.ravel(), -R @ C])
        lines.append(" ".join([name] + [f"{v:.17g}" for v in krt]))
        write_dmb(os.path.join(root, "gt", f"depth_{i:03d}.dmb"),
                  intersect_plane(P, BATCH_H, BATCH_W, n_w, d_w)[1]
                  .astype(np.float32))
        names.append(name)
    with open(os.path.join(root, "par.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return names, (n_w, d_w)


def plane_dist(np, pts, plane) -> float:
    """Median |n.X + d| / 5 of a point cloud against the plane (depth 5)."""
    n_w, d_w = plane
    return float(np.median(np.abs(np.asarray(pts, np.float64) @ n_w + d_w))
                 / 5.0)


# Batch runs (a) and (b): the CLI's extra flags and the kernels each must
# launch.
BATCH_RUNS = {"a": ([], ("bilinear_sample", "exact_window_cost",
                         "exact_warp_coords")),
              "b": (["--cost_path", "rect", "--pyramid_levels", "3",
                     "--pyramid_fine_iterations", "1"],
                    ("permute2d", "sdg_fused_cost"))}


def batch_folder(np, td: str) -> dict:
    """The batch phase's folder of views under `td`: its paths, the views'
    names and cameras, the scene's plane and the fusion's params."""
    from gipuma_tpu_torch.config import FusionParams
    from gipuma_tpu_torch.io.calib import load_projection_matrices
    stamp("batch: write the folder")
    root = os.path.join(td, "views")
    os.makedirs(root)
    names, plane = write_batch_folder(np, root)
    par = os.path.join(root, "par.txt")
    return dict(td=td, root=root, par=par, names=names, plane=plane,
                gt_tpl=os.path.join(root, "gt", "depth_{idx:03d}.dmb"),
                Ps=load_projection_matrices(names, krt_file=par),
                fp=FusionParams(disp_thresh=0.1, normal_thresh=30.0,
                                num_consistent=3))


def batch_cli_run(torch, np, device, card, folder: dict, label: str) -> dict:
    """Batch run `label` ((a) or (b)): cli.main with dino.sh's flags over
    the folder, held as the module docstring says; prints its `batch`
    line and returns its kernel launches.  Run (a) also fuses its maps on
    the card and the CPU and keeps them in `folder` (phase (i5)'s
    reference: run_dir, depths, normals, ids, ids_card, fusion_s_card,
    wall_s)."""
    from gipuma_tpu_torch import cli, kernels
    from gipuma_tpu_torch.fusion.fuse import fuse_depthmaps
    from gipuma_tpu_torch.io.dmb import read_dmb
    from gipuma_tpu_torch.io.ply import read_ply
    extra, need = BATCH_RUNS[label]
    root, names, Ps, fp = (folder["root"], folder["names"], folder["Ps"],
                           folder["fp"])
    interior = (slice(16, -16), slice(16, -16))
    stamp(f"batch ({label}): cli.main, dino.sh's flags {extra}")
    res_root = os.path.join(folder["td"], f"out_{label}")
    argv = (["-images_folder", root, "-krt_file", folder["par"],
             "-output_folder", res_root, "-gt", folder["gt_tpl"]]
            + DINO_FLAGS + extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(kernels.counts)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"batch ({label}): cli.main returned {rc}")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        fail(f"batch ({label}): kernels never launched: {missing}")
    (run_dir,) = [os.path.join(res_root, d) for d in os.listdir(res_root)]
    meds, rts, depths, normals = [], [], [], []
    for i, name in enumerate(names):
        vdir = os.path.join(run_dir, os.path.splitext(name)[0])
        depth = read_dmb(os.path.join(vdir, "disp.dmb"))
        gt_path = os.path.join(root, "gt", f"depth_{i:03d}.dmb")
        gt_i = read_dmb(gt_path)
        if not (depth.shape == gt_i.shape and np.isfinite(depth).all()):
            fail(f"batch ({label}): {name}: depth not finite or of the "
                 "wrong shape")
        med = float(np.median(np.abs(depth[interior] - gt_i[interior])
                              / gt_i[interior]))
        with open(os.path.join(vdir, "results.txt")) as f:
            text = f.read()
        head, _ = json.JSONDecoder().raw_decode(text)
        if (f"gt_file {gt_path}\n" not in text
                or "\nerror_rate_tol" not in text):
            fail(f"batch ({label}): {name}: results.txt has no GT "
                 "evaluation lines")
        if not med < 5e-3:
            fail(f"batch ({label}): {name}: median rel depth err {med} "
                 "(gate 5e-3)")
        meds.append(med)
        rts.append(head["runtime_s"])
        depths.append(depth)
        normals.append(read_dmb(os.path.join(vdir, "normals.dmb")))
    pts = read_ply(os.path.join(run_dir, "fused.ply"))[0]
    n_min = 0.25 * BATCH_H * BATCH_W
    pdist = plane_dist(np, pts, folder["plane"])
    if not (len(pts) >= n_min and pdist < 5e-3):
        fail(f"batch ({label}): fused.ply {len(pts)} points (need >= "
             f"{n_min}), median plane distance / depth {pdist}")
    depths, normals = np.stack(depths), np.stack(normals)
    # Colour = the pixel's global index: the fused colours name the kept
    # pixels, in order.
    ids = np.arange(depths.size).reshape(depths.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts_g, _, ids_g = fuse_depthmaps(depths, normals, Ps, fp, colors=ids,
                                     device=device)
    fuse_s = time.perf_counter() - t0
    line = {"metric": "batch", "run": label, "card": card,
            "views": len(names), "runtime_s": rts, "median_rel_err": meds,
            "wall_s": wall, "fusion_s_card": fuse_s,
            "points_fused_ply": len(pts), "points_card": len(pts_g),
            "plane_dist_fused_ply": pdist, "peak_allocated_GB": peak / 1e9,
            "launches": launches}
    if label == "a":
        folder.update(run_dir=run_dir, depths=depths, normals=normals,
                      ids=ids, ids_card=ids_g, fusion_s_card=fuse_s,
                      wall_s=wall)
        t0 = time.perf_counter()
        pts_c, _, ids_c = fuse_depthmaps(depths, normals, Ps, fp,
                                         colors=ids, device="cpu")
        line["fusion_s_cpu"] = time.perf_counter() - t0
        line["points_cpu"] = len(pts_c)
        d_g = plane_dist(np, pts_g, folder["plane"])
        d_c = plane_dist(np, pts_c, folder["plane"])
        line["plane_dist_card"], line["plane_dist_cpu"] = d_g, d_c
        same = ids_g.shape == ids_c.shape and bool((ids_g == ids_c).all())
        line["keep_masks_equal"] = same
        if not same:
            fail(f"batch (a): card fusion kept {len(pts_g)} pixels (plane "
                 f"distance {d_g}), the CPU's {len(pts_c)} ({d_c}): keep "
                 "masks or their order differ")
    log(json.dumps(line))
    return launches


def batch_phase(torch, np, device, card, folder: dict):
    """The scripts' path on the card (scripts/dino.sh over the folder of
    views): runs (a) and (b) through gipuma_tpu_torch.cli.main, (c)
    through run_batch with rect_quantize_shapes; each held as the module
    docstring says.  Returns {run: kernel launches}."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.config import MAXCOST, PRESETS
    from gipuma_tpu_torch.io.dmb import read_dmb
    from gipuma_tpu_torch.models import rect_scene as rs
    from gipuma_tpu_torch.models.patchmatch import init_state, make_generator
    from gipuma_tpu_torch.ops import checkerboard as cb
    from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost_batch
    from gipuma_tpu_torch.pipeline import prepare_job, run_batch

    out = {label: batch_cli_run(torch, np, device, card, folder, label)
           for label in BATCH_RUNS}
    interior = (slice(16, -16), slice(16, -16))
    td, root, par, names, Ps = (folder["td"], folder["root"], folder["par"],
                                folder["names"], folder["Ps"])

    # (c) rect_quantize_shapes through run_batch: the ledger holds the
    # three views at one bucket; each scene's info is recorded.
    stamp(f"batch (c): run_batch, rect_quantize_shapes, refs "
          f"{QUANT_REFS}")
    qp = PRESETS["middlebury"].replace(
        box_hsize=11, box_vsize=11, iterations=8, n_best=3,
        depth_min=3.0, depth_max=8.0, min_angle=0.01, max_angle=60.0,
        cost_path="rect", rect_quantize_shapes=True)
    infos = []
    build = rs.build_rect_scene

    def recording(*a, **k):
        scene, info = build(*a, **k)
        infos.append(info)
        return scene, info
    rs.build_rect_scene = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        res_c = run_batch([os.path.join(root, n) for n in names], qp,
                          os.path.join(td, "out_c"), krt_file=par,
                          ref_indices=QUANT_REFS, device=device)
        wall = time.perf_counter() - t0
    finally:
        rs.build_rect_scene = build
    launches = dict(kernels.counts)
    buckets = [i["shape_bucket"] for i in infos]
    shapes = [(max(p["rect_shape"][0] for p in i["pairs"]
                   if "rect_shape" in p),
               max(p["rect_shape"][1] for p in i["pairs"]
                   if "rect_shape" in p)) for i in infos]
    meds = []
    for ref, r in zip(QUANT_REFS, res_c):
        gt_i = read_dmb(os.path.join(root, "gt", f"depth_{ref:03d}.dmb"))
        meds.append(float(np.median(
            np.abs(r.depth[interior] - gt_i[interior]) / gt_i[interior])))
    log(json.dumps({"metric": "batch", "run": "c", "card": card,
                    "views": list(QUANT_REFS),
                    "runtime_s": [r.runtime_s for r in res_c],
                    "median_rel_err": meds, "wall_s": wall,
                    "rect_shapes": shapes, "shape_buckets": buckets,
                    "peak_allocated_GB":
                        torch.cuda.max_memory_allocated() / 1e9,
                    "launches": launches}))
    if len(buckets) != len(QUANT_REFS) or any(b != buckets[0]
                                              for b in buckets):
        fail(f"batch (c): shape buckets differ across views: {buckets}")
    if len(set(shapes)) < 2:
        fail(f"batch (c): the views' rect shapes are all {shapes[0]}")
    if not all(m < 5e-3 for m in meds):
        fail(f"batch (c): median rel depth err {meds} (gate 5e-3)")
    out["c"] = launches

    # The costs of one candidate set on the quantized and unquantized
    # scene of one view, on the card: bit-equal at every real view.
    from gipuma_tpu_torch.io.images import load_image
    imgs = [load_image(os.path.join(root, n)) for n in names]
    ref = QUANT_REFS[1]
    jq = prepare_job(imgs, Ps, qp, names, ref_index=ref, device=device)
    ju = prepare_job(imgs, Ps, qp.replace(rect_quantize_shapes=False),
                     names, ref_index=ref, device=device)

    def zero_cost(sc, p, par, n, d):
        return torch.zeros(n.shape[:2], device=device)

    with torch.no_grad():
        st = init_state(ju.prep, ju.params, make_generator(3, device),
                        zero_cost)
        eo = cb.PaddedEO.build(st.planes, 1, 3)
        cand = torch.stack([eo.shifted(dy, dx, 0) for dy, dx in
                            ((-1, 0), (1, 0), (0, -1), (0, 1))])
        kernels.reset_counts()
        c_u = rect_multiview_cost_batch(ju.prep, ju.params, 0,
                                        cand[..., :3].contiguous(),
                                        cand[..., 3].contiguous())
        c_q = rect_multiview_cost_batch(jq.prep, jq.params, 0,
                                        cand[..., :3].contiguous(),
                                        cand[..., 3].contiguous())
    same = bool(torch.equal(c_u.view(torch.int32),
                            c_q.view(torch.int32)))
    log(f"  quantized scene {tuple(jq.prep.ref_rect.shape)} vs "
        f"{tuple(ju.prep.ref_rect.shape)}: K=4 costs "
        f"{'bit-equal' if same else 'DIFFER'} "
        f"({int((c_u < MAXCOST).sum())} live), launches "
        f"{dict(kernels.counts)}")
    if not same:
        fail("batch (c): quantized and unquantized costs differ")
    del jq, ju, st, eo, cand, c_u, c_q
    torch.cuda.empty_cache()
    return out


# ---- phase (i): the parallel layer, several ranks on the card ----------

# Kernels each sub-run of phase (i) must launch on every rank.
DIST_KERNELS = {"i1": ("permute2d", "sdg_fused_cost"),
                "i2": ("bilinear_sample", "exact_window_cost",
                       "exact_warp_coords"),
                "i3": ("permute2d", "sdg_fused_cost"),
                "i4": ("bilinear_sample", "exact_window_cost",
                       "exact_warp_coords"),
                "i5": ("bilinear_sample", "exact_window_cost",
                       "exact_warp_coords")}
# Band-boundary rows of the 2-tile runs at 480 rows: 8 rows each side of
# the stitch.
SEAM_ROWS = slice(232, 248)


def dist_backend(torch, world: int) -> str:
    """NCCL with a card per rank; gloo when the ranks share cards (NCCL
    refuses a device twice)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def twice(task: dict) -> list:
    """`task`, then its repeat under the profiler: the first gives the
    walls, the second the device and collective seconds."""
    return [task, dict(task, profile=True)]


def dist_spawn(torch, world: int, tasks: list, label: str):
    """Run `tasks` on `world` ranks (parallel/launch.py) on the card;
    returns (records by rank, the spawn's wall seconds, the backend)."""
    from gipuma_tpu_torch.parallel import launch
    backend = dist_backend(torch, world)
    stamp(f"(i) {label}: {world} ranks, backend {backend}, "
          f"{torch.cuda.device_count()} card(s) visible")
    t0 = time.perf_counter()
    try:
        recs = launch.spawn(launch.run_tasks, world, args=(tasks,),
                            device="cuda", backend=backend, timeout=300)
    except (RuntimeError, TimeoutError) as e:
        fail(f"(i) {label}: {e}")
    return recs, time.perf_counter() - t0, backend


def dist_check(recs, t: int, label: str):
    """Every rank launched every kernel of the sub-run."""
    for rank, r in enumerate(recs):
        missing = [k for k in DIST_KERNELS[label] if r[t]["counts"][k] <= 0]
        if missing:
            fail(f"(i) {label}: rank {rank} never launched {missing}")


def dist_line(torch, card, label, backend, recs, t, spawn_s, iterations,
              extra, profiled=True):
    """The `dist` JSON line of sub-run `label`: record t of `recs` and,
    with `profiled`, its profiled repeat t + 1 (device seconds, and the
    collectives' seconds: NCCL's kernels on the card, gloo's spans on the
    host)."""
    rr = [r[t] for r in recs]
    col = [r["collectives"] for r in rr]
    prof = [r[t + 1]["profiled"] if profiled else None for r in recs]

    def measured(key):
        return [p[key] if p else "not measured" for p in prof]
    log(f"  {label}: host copies per rank "
        f"{[c['host_copies'] for c in col]} "
        f"({[round(c['host_copy_bytes'] / 1e6, 2) for c in col]} MB)")
    line = {"metric": "dist", "run": label, "card": card,
            "backend": backend, "world": len(rr),
            "cards_visible": torch.cuda.device_count(),
            "spawn_wall_s": spawn_s,
            "rank_entered_s": [r["startup"]["entered_s"] for r in rr],
            "rank_ready_s": [r["startup"]["ready_s"] for r in rr],
            "task_wall_s": [r["wall_s"] for r in rr],
            "task_wall_s_profiled": [r[t + 1]["wall_s"] if profiled
                                     else "not measured" for r in recs],
            "device_s": measured("device_s"),
            "collective_calls": [c["calls"] for c in col],
            "collective_bytes": [c["bytes"] for c in col],
            "collective_nccl_device_s": measured("nccl_device_s"),
            "collective_gloo_s": measured("gloo_s"),
            "host_copies": [c["host_copies"] for c in col],
            "host_copy_bytes": [c["host_copy_bytes"] for c in col],
            "peak_allocated_GB": [r["peak_bytes"] and r["peak_bytes"] / 1e9
                                  for r in rr],
            "launches": [{k: v for k, v in r["counts"].items() if v}
                         for r in rr]}
    if iterations:
        line["iterations"] = iterations
        line["collective_bytes_per_iteration"] = [
            c["bytes"] / iterations for c in col]
        if profiled:
            line["collective_s_per_iteration"] = [
                (p["nccl_device_s"] + p["gloo_s"]) / iterations
                for p in prof]
    line.update(extra)
    log(json.dumps(line))
    return line


def dist_state_diffs(np, rr, ref_planes, ref_cost):
    """Largest |difference| over the ranks of planes and cost against a
    single-process state (numpy)."""
    return (max(float(np.abs(r["planes"] - ref_planes).max()) for r in rr),
            max(float(np.abs(r["cost"] - ref_cost).max()) for r in rr))


class DistBench:
    """Phase (i)'s bench scene and its single-process references: the
    640x480 7-camera scene, the rect and exact configurations at one
    level (middlebury widths, 8 iterations, no two-stage cull: the sharded
    cost runs none)."""

    def __init__(self, torch, np, device, images, rig, gt, Ps, base):
        from gipuma_tpu_torch.geometry.camera import FAKE_BASELINE
        self.torch, self.np, self.device = torch, np, device
        self.images, self.rig, self.gt, self.Ps = images, rig, gt, Ps
        self.rect = base.replace(cost_path="rect", pyramid_levels=1)
        self.exact = base.replace(cost_path="exact", pyramid_levels=1)
        self.rect_tiled = self.rect.with_depth_range(3.0, 8.0, rig.f,
                                                     FAKE_BASELINE)
        self.iterations = base.iterations

    def job(self, params) -> dict:
        """The scene spec of parallel/launch.build: pipeline.prepare_job's
        scene and params on each rank."""
        return {"job": dict(images=self.images, Ps=self.Ps, params=params)}

    def med_err(self, depth, rows=slice(16, -16)) -> float:
        """Median relative depth error over `rows` x [16:-16]."""
        gt, s = self.gt, (rows, slice(16, -16))
        return float(self.np.median(self.np.abs(depth[s] - gt[s]) / gt[s]))

    def single(self, params, cost_fn):
        """(planes, cost, depth) of the port's single-process run."""
        from gipuma_tpu_torch.models.patchmatch import (finalize,
                                                        make_generator,
                                                        run_patchmatch)
        from gipuma_tpu_torch.pipeline import prepare_job
        torch = self.torch
        job = prepare_job(self.images, self.Ps, params, device=self.device)
        with torch.no_grad():
            st = run_patchmatch(job.prep, job.params,
                                make_generator(job.params.seed, self.device),
                                cost_fn=cost_fn)
            depth = finalize(st, job.prep)[0]
        return (st.planes.cpu().numpy(), st.cost.cpu().numpy(),
                depth.cpu().numpy())

    def held(self, label, recs, t, backend, spawn_s, card, ref, tol_cost,
             tol_planes):
        """Sub-run `label` (task t) against the single-process `ref`:
        every rank's launches, state within the tolerances, depth under the
        gate; prints and returns its dist line."""
        np = self.np
        dist_check(recs, t, label)
        rr = [r[t]["result"] for r in recs]
        dp, dc = dist_state_diffs(np, rr, ref[0], ref[1])
        meds = [self.med_err(r["depth"]) for r in rr]
        line = dist_line(self.torch, card, label, backend, recs, t, spawn_s,
                         self.iterations, {
                             "max_plane_diff": dp, "max_cost_diff": dc,
                             "median_rel_err": meds,
                             "single_median_rel_err": self.med_err(ref[2])})
        if not (dc <= tol_cost and dp <= tol_planes):
            fail(f"({label}) against one process: cost {dc}, planes {dp} "
                 f"(tolerances {tol_cost}, {tol_planes})")
        if not all(m < 5e-3 for m in meds):
            fail(f"({label}) median rel depth err {meds} (gate 5e-3)")
        return line


def dist_bench_phase(torch, card, bench):
    """Phase (i), sub-runs (i1) and (i3) on the bench scene (3 and 4
    ranks); each held as the module docstring says.  Returns {sub-run:
    its dist line}."""
    from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost
    lines = {}
    # (i1) view-sharded rect over 3 ranks, 2 views each.
    recs, spawn_s, backend = dist_spawn(torch, 3, twice(dict(
        kind="view", scene=bench.job(bench.rect), mesh=dict(view_shards=3),
        finalize=True)), "i1 view-sharded rect")
    lines["i1"] = bench.held("i1", recs, 0, backend, spawn_s, card,
                             bench.single(bench.rect, rect_multiview_cost),
                             1e-5, 1e-4)
    # (i3) tile x view rect, 2 x 2 (scripts/multichip_realistic.py's layout
    # brought down to 4 ranks).
    recs, spawn_s, backend = dist_spawn(torch, 4, twice(dict(
        kind="tiled_rect", images=bench.images, rig=bench.rig,
        views=list(range(1, len(bench.images))), params=bench.rect_tiled,
        depth=(3.0, 8.0), n_tiles=2,
        mesh=dict(tile_shards=2, view_shards=2))), "i3 tile x view rect")
    dist_check(recs, 0, "i3")
    rr = [r[0]["result"] for r in recs]
    meds = [bench.med_err(r["depth"]) for r in rr]
    seam = [bench.med_err(r["depth"], SEAM_ROWS) for r in rr]
    lines["i3"] = dist_line(torch, card, "i3", backend, recs, 0, spawn_s,
                            bench.iterations, {
                                "median_rel_err": meds,
                                "seam_median_rel_err": seam,
                                "margin": rr[0]["margin"],
                                "h_pad": rr[0]["h_pad"]})
    if not all(m < 5e-3 for m in meds):
        fail(f"(i3) median rel depth err {meds} (gate 5e-3)")
    if not all(m < 1e-2 for m in seam):
        fail(f"(i3) band-seam median rel depth err {seam} (gate 1e-2)")
    return lines


def dist_pair_phase(torch, np, card, bench, folder):
    """Phase (i), the 2-rank sub-runs in one world: (i2) view-sharded
    exact and (i4) tiled exact (propagation only) on the bench scene, then
    (i5) the CLI's --distributed over batch run (a)'s folder and the
    sharded fusion of run (a)'s maps.  Returns {sub-run: its dist line}."""
    from gipuma_tpu_torch.io.dmb import read_dmb
    from gipuma_tpu_torch.io.ply import read_ply
    from gipuma_tpu_torch.ops.cost import multiview_cost
    interior = (slice(16, -16), slice(16, -16))
    prop = bench.exact.replace(refine=False)
    out_dir = os.path.join(folder["td"], "out_i5")
    argv = (["-images_folder", folder["root"], "-krt_file", folder["par"],
             "-output_folder", out_dir, "-gt", folder["gt_tpl"]]
            + DINO_FLAGS + ["--distributed"])
    # The CLI runs once, unprofiled (a profiled repeat of all 16 views
    # would double the phase's longest sub-run); its sharded fusion is
    # profiled on its own below.
    recs, spawn_s, backend = dist_spawn(torch, 2, (
        twice(dict(kind="view", scene=bench.job(bench.exact),
                   mesh=dict(view_shards=2), finalize=True))
        + twice(dict(kind="tile", scene=bench.job(prop),
                     mesh=dict(tile_shards=2)))
        + [dict(kind="cli", argv=argv)]
        + twice(dict(kind="fuse", depths=folder["depths"],
                     normals=folder["normals"], Ps=folder["Ps"],
                     params=folder["fp"],
                     mesh=dict(view_shards=2, max_view_shards=2),
                     colors=folder["ids"]))),
        "i2 view-sharded exact, i4 tiled exact (propagation only), "
        "i5 CLI --distributed and sharded fusion")
    lines = {"i2": bench.held("i2", recs, 0, backend, spawn_s, card,
                              bench.single(bench.exact, multiview_cost),
                              1e-5, 1e-4),
             "i4": bench.held("i4", recs, 2, backend, spawn_s, card,
                              bench.single(prop, multiview_cost),
                              1e-6, 1e-6)}
    dist_check(recs, 4, "i5")
    rcs = [r[4]["result"]["rc"] for r in recs]
    if rcs != [0, 0]:
        fail(f"(i5) cli.main --distributed returned {rcs}")
    differ, max_diff, meds = [], 0.0, []
    for i, name in enumerate(folder["names"]):
        stem = os.path.splitext(name)[0]
        got = read_dmb(os.path.join(out_dir, stem, "disp.dmb"))
        want = read_dmb(os.path.join(folder["run_dir"], stem, "disp.dmb"))
        gt_i = read_dmb(os.path.join(folder["root"], "gt",
                                     f"depth_{i:03d}.dmb"))
        if not np.array_equal(got, want):
            differ.append(name)
            max_diff = max(max_diff, float(np.abs(got - want).max()))
        meds.append(float(np.median(np.abs(got[interior] - gt_i[interior])
                                    / gt_i[interior])))
    pts_d = read_ply(os.path.join(out_dir, "fused.ply"))[0]
    pts_a = read_ply(os.path.join(folder["run_dir"], "fused.ply"))[0]
    ply_diff = (float(np.abs(pts_d - pts_a).max())
                if pts_d.shape == pts_a.shape else None)
    fused = [r[5]["result"] for r in recs]
    keep_equal = [bool(np.array_equal(f["colors"], folder["ids_card"]))
                  for f in fused]
    fusion_prof = [r[6]["profiled"] for r in recs]
    lines["i5"] = dist_line(torch, card, "i5", backend, recs, 4, spawn_s,
                            None, {
        "views": len(folder["names"]), "views_not_bit_equal": differ,
        "max_disp_diff": max_diff, "median_rel_err": meds,
        "fused_ply_points": len(pts_d),
        "single_fused_ply_points": len(pts_a),
        "fused_ply_max_point_diff": ply_diff,
        "single_run_a_wall_s": folder["wall_s"],
        "sharded_fusion_s": [r[5]["wall_s"] for r in recs],
        "sharded_fusion_device_s": [p["device_s"] for p in fusion_prof],
        "sharded_fusion_collective_s": [p["nccl_device_s"] + p["gloo_s"]
                                        for p in fusion_prof],
        "sharded_fusion_collective_bytes": [r[5]["collectives"]["bytes"]
                                            for r in recs],
        "single_fusion_s_card": folder["fusion_s_card"],
        "sharded_fusion_keep_equal": keep_equal}, profiled=False)
    if not all(m < 5e-3 for m in meds):
        fail(f"(i5) median rel depth err {meds} (gate 5e-3)")
    if ply_diff is None or ply_diff > 1e-5:
        fail(f"(i5) fused.ply: {len(pts_d)} points against one process's "
             f"{len(pts_a)}, largest point difference {ply_diff} (1e-5)")
    if not all(keep_equal):
        fail(f"(i5) the sharded fusion kept other pixels than the card's "
             f"single-process fusion: {keep_equal}")
    return lines


# The exact PM window sum's unit shapes in the benchmark's cells: (K
# candidates a launch, box, increment, H, W); C = 1.
EXACT_COST_SHAPES = {"dino": (4, 11, 2, 480, 640),
                     "dtu_fast": (1, 15, 2, 1200, 1600)}


def exact_cost_lines(torch, card) -> dict:
    """The exact PM cost's window-sum kernel (csrc/exact_cost.cu) at each
    EXACT_COST_SHAPES unit, beside its plain version and its bound: a
    noise reference image with its central gradients, padded as the scene
    pads them, and samples that are the reference's own windows plus
    noise (matching costs, as near a converged plane).  Held to 1e-4 abs
    against the plain version; device time by CUDA-graph replay.  Bound:
    the samples read once and the costs written once at HBM rate (the
    reference planes are L2-resident)."""
    from gipuma_tpu_torch.config import MAXCOST, AlgorithmParams
    from gipuma_tpu_torch.ops import checkerboard as cb
    from gipuma_tpu_torch.ops import cost as ec
    from gipuma_tpu_torch.ops.sampling import central_gradients
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    lines = {}
    for cell, (K, box, inc, H, W) in EXACT_COST_SHAPES.items():
        p = AlgorithmParams(box_hsize=box, box_vsize=box,
                            window_increment=inc)
        offs = ec.window_offsets(p)
        O = len(offs)
        img = torch.rand((1, H, W), generator=g, device=dev) * 200 + 20
        gx, gy = central_gradients(img)
        pr, pc = p.box_vrad, p.box_hrad + 2
        eos = [cb.PaddedEO.build(a.permute(1, 2, 0), pr, pc)
               for a in (img, gx, gy)]
        wins = torch.cat([eo.windows(offs, 0).permute(0, 3, 1, 2)
                          for eo in eos], 1)              # [O, 3, H, W2]
        smp = (wins[None] + torch.randn((K, O, 3, H, W // 2), generator=g,
                                        device=dev) * 2.0
               ).reshape(K * O, 3, H, W // 2).contiguous()
        del wins
        scene = ec.ScenePack(**dict.fromkeys(ec.ScenePack._fields)).\
            _replace(view_valid=torch.ones(1, device=dev), ref_img=eos[0],
                     ref_gx=eos[1], ref_gy=eos[2])
        ref, rgx, rgy, table = ec.exact_window_inputs(scene, offs, dev)
        terms = ec.pm_reference_terms(scene, p, offs, 0)
        valid = scene.view_valid
        out = torch.empty((K, H, W // 2), device=dev)

        def kern():
            ec.exact_window_cost_cuda(smp, ref, rgx, rgy, table, valid, 0,
                                      out, 0, pr, eos[0].pc, p)

        kern()
        want = ec.pm_window_cost_plain(smp, terms, p, valid[0])
        fin = want < MAXCOST
        if not bool(fin.all()) or not torch.equal(out < MAXCOST, fin):
            fail(f"exact_window_cost ({cell}): non-finite costs")
        err = float((out - want).abs().max())
        if not err <= 1e-4:
            fail(f"exact_window_cost differs from its plain version "
                 f"({cell}): max abs diff {err}")
        nbytes = 4 * (smp.numel() + out.numel() + 3 * ref.numel())
        lines[cell] = {
            "kernel": "exact_window_cost", "card": card,
            "shape": f"K={K} x {O} offsets (box {box}/inc {inc}), "
                     f"{H}x{W // 2} half-grid, C=1",
            "ms": graph_ms(kern, reps=10),
            "plain_ms": graph_ms(lambda: ec.pm_window_cost_plain(
                smp, terms, p, valid[0]), reps=3, rounds=3),
            "library_ms": None, "bound_ms": nbytes / HBM_BPS * 1e3,
            "bound_by": "bytes", "max_abs_err": err,
            "mean_cost": float(want.mean())}
        del smp, terms, want, out
        torch.cuda.empty_cache()
    return lines


def exact_warp_lines(torch, card) -> dict:
    """The exact PM cost's warp prologue (csrc/exact_cost.cu,
    exact_warp_coords_kernel) at each EXACT_COST_SHAPES unit, beside its
    plain version warped_coords and its bound: a rig whose source camera
    sits a tenth of the depth to the side, turned 2 degrees, and planes
    near a fronto-parallel one 4-5 units away.  Held bit-equal to
    warped_coords; device time by CUDA-graph replay.  Bound: the
    positions written once (8 B each) and the plane and view terms read
    once, at HBM rate."""
    import math
    from gipuma_tpu_torch.config import AlgorithmParams
    from gipuma_tpu_torch.geometry import transforms as T
    from gipuma_tpu_torch.ops import cost as ec
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    lines = {}
    for cell, (K, box, inc, H, W) in EXACT_COST_SHAPES.items():
        p = AlgorithmParams(box_hsize=box, box_vsize=box,
                            window_increment=inc)
        offs = ec.window_offsets(p)
        O = len(offs)
        f = 1.2 * W
        k1 = torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2],
                           [0.0, 0.0, 1.0]], dtype=torch.float64)
        a = math.radians(2.0)
        rot = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                            [-math.sin(a), 0.0, math.cos(a)]],
                           dtype=torch.float64)
        kinv = torch.linalg.inv(k1)
        y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                              torch.arange(W, dtype=torch.float32),
                              indexing="ij")
        kinv32 = kinv.float().to(dev)
        scene = ec.ScenePack(**dict.fromkeys(ec.ScenePack._fields))._replace(
            A=(k1 @ rot).float()[None].to(dev),
            b=(k1 @ torch.tensor([0.45, 0.0, 0.0], dtype=torch.float64)
               ).float()[None].to(dev),
            k1inv_c0=kinv32[:, 0].contiguous(),
            k1inv_c1=kinv32[:, 1].contiguous(),
            rays=T.pixel_rays(kinv32, x.to(dev), y.to(dev)))
        n = torch.randn((K, H, W // 2, 3), generator=g, device=dev) * 0.05
        n[..., 2] = -1.0
        n = n / n.norm(dim=-1, keepdim=True)
        d = 4.0 + torch.rand((K, H, W // 2), generator=g, device=dev)
        warp = ec._plane_terms(scene, 0, n, d)
        ar, ac0, ac1 = ec.view_warp_terms(scene, 0, warp.rays)
        table = ec.offset_tables(offs, dev)[0]
        xw = torch.empty((K * O, H, W // 2), device=dev)
        yw = torch.empty_like(xw)

        def kern():
            ec.exact_warp_coords_cuda(ar, ac0, ac1, scene.b[0], warp.mr,
                                      warp.mc0, warp.mc1, table, xw, yw)

        kern()
        want = ec.warped_coords(scene, 0, warp, offs)
        if not (bool(torch.isfinite(want[0]).all())
                and bool(torch.isfinite(want[1]).all())):
            fail(f"exact_warp_coords ({cell}): non-finite positions")
        for got, w, what in ((xw, want[0], "xw"), (yw, want[1], "yw")):
            if not torch.equal(got.view(torch.int32), w.view(torch.int32)):
                fail(f"exact_warp_coords ({cell}): {what} differs from "
                     f"warped_coords at {int((got != w).sum())} positions")
        nbytes = 4 * (xw.numel() + yw.numel() + 3 * warp.mr.numel()
                      + ar.numel() + 9)
        ms = graph_ms(kern, reps=10)
        bound = nbytes / HBM_BPS * 1e3
        lines[cell] = {
            "kernel": "exact_warp_coords", "card": card,
            "shape": f"K={K} x {O} offsets (box {box}/inc {inc}), "
                     f"{H}x{W // 2} half-grid",
            "ms": ms,
            "plain_ms": graph_ms(lambda: ec.warped_coords(
                scene, 0, warp, offs), reps=3, rounds=3),
            "library_ms": None, "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / ms, "bit_equal": True,
            "x_range": [float(xw.min()), float(xw.max())]}
        del warp, want, xw, yw, ar, n, d
        torch.cuda.empty_cache()
    return lines


def dino_sampler_unit(torch, xs, xp, v0: int = 0):
    """The sampler's K=4 unit on the bench scene's exact job (scene xs,
    parameters xp): the close propagation sweep's four candidates of
    parity 0 from random-init planes, view v0's positions at every window
    offset, [4 * 36, 480, 320], with the first and last 8 columns and rows
    pushed 20 px outside the image.  Returns (source, x, y, offsets)."""
    from gipuma_tpu_torch.models.patchmatch import init_state, make_generator
    from gipuma_tpu_torch.ops import checkerboard as cb
    from gipuma_tpu_torch.ops import cost as ec
    device = xs.src.device

    def zero_cost(s, p, par, n, d):
        return torch.zeros(n.shape[:2], device=device)

    with torch.no_grad():
        st_x = init_state(xs, xp, make_generator(1, device),
                          cost_fn=zero_cost)
    eo = cb.PaddedEO.build(st_x.planes, 1, 3)
    cand = torch.stack([eo.shifted(dy, dx, 0)
                        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))])
    offs = ec.window_offsets(xp)
    sx, sy = ec.warped_coords(xs, v0, ec._plane_terms(
        xs, 0, cand[..., :3], cand[..., 3]), offs)
    xH, xW = xs.src.shape[-2:]
    sx[:, :, :8] = -20.0                       # 20 px outside the image
    sx[:, :, -8:] = xW - 1 + 20.0
    sy[:, :8] = -20.0
    sy[:, -8:] = xH - 1 + 20.0
    return xs.src[v0], sx, sy, offs


def clamped_share(torch, x, y, H: int, W: int) -> float:
    """Share of sample positions the sampler clamps to the image's edge:
    x outside [0, W-1] or y outside [0, H-1], or NaN."""
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return 1.0 - float(inside.float().mean())


def smooth_sampler_field(torch, offs, H: int, W2: int, dev):
    """Positions of the identity warp at every window offset, [O, H, W2]
    each: pixel (h, 2 w2 + h % 2) of the half-grid plus (dx, dy), so
    neighbouring pixels read neighbouring texels at every offset."""
    dx = torch.tensor([o[0] for o in offs], dtype=torch.float32, device=dev)
    dy = torch.tensor([o[1] for o in offs], dtype=torch.float32, device=dev)
    h = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    w = torch.arange(W2, dtype=torch.float32, device=dev)[None]
    x = (2 * w + h.remainder(2))[None] + dx[:, None, None]
    y = h.expand(H, W2)[None] + dy[:, None, None]
    return x.contiguous(), y.contiguous()


# The sampler calls whose positions cell_sampler_fields keeps: the random
# init's first call, the first call after the first iteration, the first
# call of the last iteration (its close propagation sweep) and the run's
# last call (the last iteration's last refinement round).
FIELD_STAGES = ("init", "after_first", "last_close", "last")


def cell_job(torch, workload: str = "dtu_fast.exact", seed: int = 7,
             ref: int | None = None):
    """A benchmark cell's prepared job on the card: the benchmark's own
    scene (portbench/scene.py) and parameters, view `ref` (the cell's
    first window view by default)."""
    from gipuma_tpu_torch import pipeline
    from portbench import core as pcore
    from portbench import scene as pscene
    dev = torch.device("cuda")
    cell = pcore.load_cell(workload)
    params = pcore.program_params(cell.config, cell.mix)
    sc = pscene.make_scene(cell.config, seed, dev)
    names = [f"view{i:03d}" for i in range(len(sc.images))]
    ref = cell.config["window_views"][0] if ref is None else ref
    return pipeline.prepare_job(sc.images, sc.Ps, params, names,
                                ref_index=ref, device=dev)


def cell_sampler_fields(torch, job, sampler=None):
    """The sampler's units as a benchmark cell runs them (DTU's: 1 x 64
    offsets x 1200 x 800 half-grid, C = 3): one PM run of `job`
    (cell_job) under the profiler, the sampler (`sampler`, by default
    the package's) recorded at each call with its stage (the iteration
    and the sweep: init, close, far or refine) and its device time.
    Returns (source [C, H, W], {FIELD_STAGES label: (x, y)},
    [(iteration, sweep, ms)] per call)."""
    from torch.profiler import ProfilerActivity, profile
    from gipuma_tpu_torch import pipeline
    from gipuma_tpu_torch.models import patchmatch as tpmm
    from gipuma_tpu_torch.ops import cost as ec
    params = job.params
    last_it = params.iterations - 1
    where = {"it": -1, "sweep": "init"}
    calls, kept = [], {}
    orig = {"sample": ec.bilinear_sample, "iteration": tpmm.iteration,
            "prop": tpmm.propagation_sweep, "refine": tpmm.refinement_sweep}

    def sample(src, x, y):
        it, sweep = where["it"], where["sweep"]
        first = not calls or calls[-1][:2] != (it, sweep)
        calls.append((it, sweep))
        label = ("init" if it == -1 and len(calls) == 1 else
                 "after_first" if it == 1 and len(calls) > 1
                 and calls[-2][0] == 0 else
                 "last_close" if it == last_it and first
                 and sweep == "close" else None)
        if label and label not in kept:
            kept[label] = (x.clone(), y.clone())
        kept["last"] = (x, y)
        kept["src"] = src
        return (sampler or orig["sample"])(src, x, y)

    def iteration(state, *a, **k):
        where["it"] += 1
        return orig["iteration"](state, *a, **k)

    def prop(state, scene, params, parity, offsets, *a, **k):
        where["sweep"] = ("far" if tuple(offsets) == tpmm.FAR_OFFSETS
                          else "close")
        return orig["prop"](state, scene, params, parity, offsets, *a, **k)

    def refine(*a, **k):
        where["sweep"] = "refine"
        return orig["refine"](*a, **k)

    ec.bilinear_sample, tpmm.iteration = sample, iteration
    tpmm.propagation_sweep, tpmm.refinement_sweep = prop, refine
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) \
                as prof:
            pipeline.run_prepared_job(job)
            torch.cuda.synchronize()
    finally:
        ec.bilinear_sample, tpmm.iteration = orig["sample"], orig["iteration"]
        tpmm.propagation_sweep, tpmm.refinement_sweep = (orig["prop"],
                                                         orig["refine"])
    evs = sorted((ev.start_ns(), ev.duration_ns())
                 for ev in prof.profiler.kineto_results.events()
                 if str(ev.device_type()).endswith("CUDA")
                 and "bilinear_sample_kernel" in ev.name())
    src = kept.pop("src")
    kept["last"] = tuple(t.clone() for t in kept["last"])
    # The profiler drops a kernel event now and then; the stages' times
    # are then not read (None).
    per_call = ([(it, sw, d / 1e6) for (it, sw), (_, d) in zip(calls, evs)]
                if len(evs) == len(calls) else
                [(it, sw, None) for it, sw in calls])
    return src, {k: kept[k] for k in FIELD_STAGES}, per_call


def sampler_stage_ms(per_call) -> dict:
    """{stage: [calls, device ms]} of cell_sampler_fields' calls: init,
    then propagation and refinement of the first two iterations (early)
    and of the rest (late); ms None where the events were not read."""
    out = {}
    for it, sweep, ms in per_call:
        key = "init" if it < 0 else "%s_%s" % (
            "early" if it < 2 else "late",
            "refine" if sweep == "refine" else "prop")
        n, t = out.get(key, (0, 0.0))
        out[key] = (n + 1, None if ms is None or t is None else t + ms)
    return {k: list(v) for k, v in out.items()}


def sampler_field_lines(torch, card) -> dict:
    """The sampler at DTU's unit (1 x 64 offsets x 1200 x 800, C = 3) on
    the benchmark's own fields (cell_sampler_fields: the random init's
    first call and the run's last call) and on the identity warp
    (smooth_sampler_field), on every route, each held bit-equal to the
    plain version, beside the bound (8 B of positions and 12 B of samples
    a position, the source read once, at HBM rate); each field's clamped
    share; and the view's sampler time by stage on the route the shape
    picks."""
    from gipuma_tpu_torch.ops import cost as ec
    from gipuma_tpu_torch.ops.sampling import (SAMPLER_ROUTES,
                                               bilinear_sample_on_route,
                                               bilinear_sample_plain,
                                               sampler_route)
    job = cell_job(torch, "dtu_fast.exact")
    src, fields, per_call = cell_sampler_fields(torch, job)
    C, H, W = src.shape
    cases = {"init": fields["init"], "last": fields["last"],
             "smooth": smooth_sampler_field(
                 torch, ec.window_offsets(job.params), H, W // 2,
                 src.device)}
    del fields, job
    lines = {}
    for label, (x, y) in cases.items():
        want = bilinear_sample_plain(src, x, y)
        ms = {}
        for route in SAMPLER_ROUTES:
            bit_equal(bilinear_sample_on_route(src, x, y, route), want,
                      f"DTU unit, {label} field, route {route}",
                      "bilinear_sample")
            ms[route] = graph_ms(lambda: bilinear_sample_on_route(
                src, x, y, route), reps=10)
        del want
        bound = (x.numel() * (8 + 4 * C) + 4 * src.numel()) / HBM_BPS * 1e3
        lines[label] = {
            "kernel": "bilinear_sample", "card": card,
            "shape": f"src {tuple(src.shape)}, coords {tuple(x.shape)} "
                     f"(DTU unit, {label} field)",
            "clamped_share": clamped_share(torch, x, y, H, W),
            "route": sampler_route(x.shape[0]), "ms_by_route": ms,
            "bound_ms": bound, "bound_by": "bytes",
            "bound_share_by_route": {r: bound / t for r, t in ms.items()},
            "bit_equal": True}
        torch.cuda.empty_cache()
    lines["init"]["view_sampler_ms_by_stage"] = sampler_stage_ms(per_call)
    return lines


def main() -> int:
    if len(sys.argv) > 1:
        fail(f"chip_smoke.py takes no arguments: {sys.argv[1:]}", 2)
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs the card",
             2)
    try:
        import numpy as np
        import gipuma_tpu_torch
        from gipuma_tpu_torch import kernels
        from gipuma_tpu_torch.ops import checkerboard as cb
        from gipuma_tpu_torch.ops import cost as ec
        from gipuma_tpu_torch.ops import rect_cost as rc
        from gipuma_tpu_torch.ops.permute2d import (permute2d_cuda,
                                                    permute2d_index,
                                                    permute2d_plain)
        from gipuma_tpu_torch.ops.rowgather import (
            row_gather_affine_cuda, row_gather_affine_plain,
            row_gather_affine_rows_cuda, row_gather_affine_rows_plain,
            row_gather_lerp_cuda, row_gather_lerp_plain,
            row_gather_nearest_cuda, row_gather_nearest_plain)
        from gipuma_tpu_torch.ops.sampling import (bilinear_sample_cuda,
                                                   bilinear_sample_on_route,
                                                   bilinear_sample_plain,
                                                   sampler_route)
        from gipuma_tpu_torch.ops.sdg_fused import (
            fused_sdg_cost_batch_cuda, fused_sdg_cost_batch_plain)
        from gipuma_tpu_torch.pipeline import (compute_depthmap, prepare_job,
                                               run_prepared_job,
                                               write_outputs)
        from gipuma_tpu_torch.models import patchmatch as tpmm
        from gipuma_tpu_torch.models.patchmatch import (init_state,
                                                        make_generator)
    except ImportError as e:
        fail(f"the gipuma_tpu_torch package is not beside this script: {e}",
             3)
    foreign = gipuma_tpu_torch.foreign_modules()
    if foreign:
        fail(f"the port imported JAX / the JAX package: {foreign[:5]}")

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc_version()}")
    try:
        import PIL
        log(f"PIL: importable, version {PIL.__version__}")
    except ImportError:
        log("PIL: not importable (the port's image loader does without)")

    # ---- 2. build ---------------------------------------------------------
    stamp("build")
    t0 = time.perf_counter()
    secs = kernels.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
        f" total {time.perf_counter() - t0:.2f} s")
    for name, text in kernels.build_log.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas[{name}]: {ln.strip()}")
    for name in kernels.SOURCES:
        kernels.library(name)

    # ---- scenes of the paths ---------------------------------------------
    stamp("scenes")
    images, rig, gt, Ps, paths = scene_setup()
    params = paths["rect"]
    jobs, prep_s = {}, {}
    for label in ("rect", "exact"):
        t0 = time.perf_counter()
        jobs[label] = prepare_job(images, Ps, paths[label], device=device)
        prep_s[label] = time.perf_counter() - t0
    job = jobs["rect"]
    scene, jparams = job.prep, job.params
    log(f"scene: {scene.num_views} views, rect {tuple(scene.ref_rect.shape)}"
        f", S {scene.fwd_c1.shape[-2]}, rot {scene.rotations()}, "
        f"prep {prep_s['rect']:.2f} s; exact scene src "
        f"{tuple(jobs['exact'].prep.src.shape)}, prep "
        f"{prep_s['exact']:.2f} s")

    # ---- 3. kernels vs plain versions at main-path shapes ----------------
    stamp("kernels vs plain versions")
    gen = make_generator(0, device)

    def zero_cost(s, p, par, n, d):
        return torch.zeros(n.shape[:2], device=device)

    h, w = gt.shape
    R = len(jparams.refinement_schedule())
    v0 = 0
    m_words, abc_of = bench_inputs(torch, scene, jparams, device, v0)

    # The forward and return permutations of view 0 (int32 words of K=1
    # plane pairs and K=4 f16 triples, f32 planes, an f32 cost and K=4
    # f16 cost pairs), each with its two pass masks.
    hrp, wrp = scene.ref_rect.shape[-2:]
    cost_src = (torch.rand((1, hrp, wrp), generator=gen, device=device)
                * 50.0).contiguous()
    fwd_src_pair = m_words(1, "pair")
    fwd_t = (scene.fwd_c1[v0], scene.fwd_r[v0],
             pass1_mask(torch, scene.fwd_r[v0], scene.fwd2_ok[v0],
                        scene.fwd_c1.shape[-2]), scene.fwd2_ok[v0])
    ret_t = (scene.ret_c1[v0], scene.ret_r[v0],
             pass1_mask(torch, scene.ret_r[v0], scene.ret2_ok[v0],
                        scene.ret_c1.shape[-2]), scene.ret2_ok[v0])
    perm_cases = [   # (what, x, c1, r, mask1, mask2)
        ("fwd int32 K=1", fwd_src_pair, *fwd_t),
        ("fwd int32 K=4 tri", m_words(4, "tri"), *fwd_t),
        ("fwd f32 K=1", m_words(1, "none"), *fwd_t[:2], None, None),
        ("ret f32 K=1", cost_src, *ret_t),
        ("ret int32 K=4", rc._pack_f16_pairs(
            cost_src.expand(4, hrp, wrp)).contiguous(), *ret_t)]

    log("kernel vs plain: row_gather_nearest")
    gather_cases = []   # (what, src, x, mask)
    for what, src, c1, r, m1, m2 in perm_cases:
        gather_cases.append((f"{what} pass1", src.contiguous(),
                             c1[None].contiguous(), m1))
        a = row_gather_nearest_plain(src, c1[None])[0]
        gather_cases.append((f"{what} pass2", a.transpose(1, 2).contiguous(),
                             r.t().contiguous()[None], m2))
    max_err_gather = 0.0
    for what, src, x, mask in gather_cases:
        for use_mask in ((False, True) if mask is not None else (False,)):
            mk = mask if use_mask else None
            want = row_gather_nearest_plain(src, x)
            got = row_gather_nearest_cuda(src, x, mk)
            max_err_gather = max(max_err_gather, masked_equal(
                got, want, mk, f"{what} {src.dtype} {tuple(src.shape)}->"
                               f"{tuple(x.shape)} mask={use_mask}"))
    del gather_cases

    # The one-pass permutation: its plain version equals the two plain
    # passes everywhere; the kernel equals its plain version at consumed
    # coordinates (the outputs of mask2's on tiles; the first pass's mask
    # has no counterpart).
    log("kernel vs plain: permute2d")
    max_err_perm = 0.0
    for what, src, c1, r, m1, m2 in perm_cases:
        want = permute2d_plain(src, c1, r)
        a = row_gather_nearest_plain(src, c1[None])[0]
        two = row_gather_nearest_plain(a.transpose(1, 2).contiguous(),
                                       r.t().contiguous()[None])[0]
        masked_equal(want.transpose(1, 2)[None], two[None], None,
                     f"{what}: plain one pass vs two plain passes",
                     "permute2d_plain")
        for use_mask in ((False, True) if m2 is not None else (False,)):
            mk = m2 if use_mask else None
            got = permute2d_cuda(src, c1, r, mk)
            if got.shape != want.shape or not got.is_contiguous():
                fail(f"permute2d: {what}: shape {tuple(got.shape)}")
            # mask2 tiles lie over the transposed [out_w, out_h] output.
            max_err_perm = max(max_err_perm, masked_equal(
                got.transpose(1, 2)[None], want.transpose(1, 2)[None], mk,
                f"{what} {src.dtype} {tuple(src.shape)}->"
                f"{tuple(got.shape)} mask={use_mask}", "permute2d"))
        del want, a, two, got

    log("kernel vs plain: sdg_fused_cost")
    ref_v = scene.ref_rect[v0]
    src_v = scene.src_rect[v0]
    db_v = scene.disp_bounds[v0].contiguous()
    hw_v = scene.hw_valid[v0].contiguous()
    tm_v = scene.tile_ok[v0].contiguous()
    cov = tm_v.to(torch.bool).repeat_interleave(8, 0).repeat_interleave(
        128, 1)[:hrp, :wrp].clone()
    hv, wv = (int(a) for a in scene.hw_valid[v0].tolist())
    cov[(hv + 7) // 8 * 8:] = False
    cov[:, (wv + 127) // 128 * 128:] = False
    every = torch.ones_like(cov)
    full_p = jparams
    cull_p = jparams.replace(box_hsize=jparams.cull_box,
                             box_vsize=jparams.cull_box,
                             window_increment=jparams.cull_increment)

    # (what, params, abc, ref, src, hw_valid, tile_ok, covered pixels)
    fused_cases = []
    for K in sorted({1, 4, R}):
        for label, p in (("box11/inc2", full_p), ("cull box9/inc4", cull_p)):
            abc = abc_of(K, "pair" if K == 1 else "tri")
            fused_cases.append((f"K={K} {label}", p, abc, ref_v, src_v,
                                hw_v, tm_v, cov))
    # Every tile, the image borders included (no hw_valid, no tile mask).
    fused_cases.append(("K=1 box11/inc2 every tile", full_p,
                        fused_cases[0][2], ref_v, src_v, None, None, every))
    # C=3: view 0's channels and their column shifts as three channels.
    ref3 = torch.cat([torch.cat([ref_v[q:q + 1], ref_v[q:q + 1].roll(3, 1),
                                 ref_v[q:q + 1].roll(-5, 1)])
                      for q in range(3)]).contiguous()
    src3 = torch.cat([src_v, src_v.roll(3, 1), src_v.roll(-5, 1)]
                     ).contiguous()
    fused_cases.append(("K=1 box11/inc2 C=3", full_p, fused_cases[0][2],
                        ref3, src3, hw_v, tm_v, cov))
    max_err_fused = 0.0
    for what, p, abc, fref, fsrc, fhw, ftm, fcov in fused_cases:
        want = fused_sdg_cost_batch_plain(fref, fsrc, abc, p, db_v[0],
                                          db_v[1])
        got = fused_sdg_cost_batch_cuda(fref, fsrc, abc, p, db_v, fhw, ftm)
        diff = (got - want).abs()[:, fcov]
        err = float(diff.max()) if diff.numel() else 0.0
        max_err_fused = max(max_err_fused, err)
        log(f"  {what}: {int(fcov.sum())} covered px, max |diff| {err:.3g}")
        if not err <= 1e-3:
            fail(f"sdg_fused_cost differs from its plain version: {what} "
                 f"max abs diff {err}")
    del ref3, src3

    log("kernel vs plain: bilinear_sample")
    xs, xp = jobs["exact"].prep, jobs["exact"].params
    s_src, sx, sy, offs = dino_sampler_unit(torch, xs, xp, v0)
    xH, xW = xs.src.shape[-2:]
    want = bilinear_sample_plain(s_src, sx, sy)
    got = bilinear_sample_cuda(s_src, sx, sy)
    both_nan = torch.isnan(got) & torch.isnan(want)
    differ = int(((got != want) & ~both_nan).sum())
    fin = torch.isfinite(got) & torch.isfinite(want)
    max_err_sample = float((got - want).abs()[fin].max()) \
        if bool(fin.any()) else 0.0
    log(f"  src {tuple(s_src.shape)}, coords {tuple(sx.shape)} "
        f"({len(offs)} offsets x 4 candidates): {got.numel()} values "
        f"({sx.numel()} positions x {s_src.shape[0]} channels), {differ} "
        f"differ, max |diff| {max_err_sample:.3g}")
    if differ:
        fail(f"bilinear_sample differs from its plain version: {differ} "
             f"samples, max abs diff {max_err_sample}")
    del want, got, both_nan, fin
    torch.cuda.synchronize()

    # The lerp gather on view 0 of the full-channel (PACKED), grad_fwd
    # (PACKED+GFWD) and f32-tap scenes: the K=4 propagation candidates at
    # the window's corner offset (-5, -5), the row shift done in the
    # gather; a NaN row and positions 20 px outside [0, W-1] mixed in.
    log("kernel vs plain: row_gather_lerp")
    for label in ("full", "gfwd", "f32"):
        t0 = time.perf_counter()
        jobs[label] = prepare_job(images, Ps, paths[label], device=device)
        prep_s[label] = time.perf_counter() - t0
    corner = -jparams.box_hrad
    lerp_cases = {}
    max_err_lerp = 0.0
    for label, mode in (("f32", "f32"), ("full", "PACKED"),
                        ("gfwd", "PACKED+GFWD")):
        sc = jobs[label].prep
        lsrc = sc.src_rect[v0]
        lh, lw = lsrc.shape[-2:]
        a4 = abc_of(4, "tri", sc)
        lxg = torch.arange(lw, device=device, dtype=torch.float32)[None]
        lyg = torch.arange(lh, device=device, dtype=torch.float32)[:, None]
        ldb = sc.disp_bounds[v0]
        ldisp = (a4[:, 0] * (lxg + corner) + a4[:, 1] * (lyg + corner)
                 + a4[:, 2])
        lx = ((lxg + corner) - torch.minimum(torch.maximum(ldisp, ldb[0]),
                                             ldb[1])).contiguous()
        lx[0, 0] = float("nan")
        lx[1, :, :8] = -20.0
        lx[1, :, -8:] = lw - 1 + 20.0
        gfwd = mode.endswith("GFWD")
        want = row_gather_lerp_plain(lsrc, lx, gfwd, corner)
        got = row_gather_lerp_cuda(lsrc, lx, gfwd, corner)
        max_err_lerp = max(max_err_lerp, bit_equal(
            got, want, f"{mode} src {lsrc.dtype} {tuple(lsrc.shape)} -> "
                       f"{tuple(got.shape)}", "row_gather_lerp"))
        lerp_cases[label] = (mode, lsrc, lx, gfwd, a4)
        del want, got

    # The affine gather at the census path's largest row launch: K=4
    # candidates x the 11 columns of one window row, on view 0's packed
    # image words; one NaN plane row and planes far outside the clamp,
    # with the scene's clamp and with an open one.
    log("kernel vs plain: row_gather_affine")
    a_src = scene.src_rect[v0]
    a_abc = abc_of(4, "tri").clone()
    a_abc[0, 2, 0] = float("nan")
    a_abc[1, 2, 1, :64] = 1e4
    a_abc[2, 2, 2, :64] = -1e4
    a_dxs = tuple(range(-jparams.box_hrad, jparams.box_hrad + 1))
    a_db_open = torch.tensor([-1e9, 1e9], device=device)
    max_err_affine = 0.0
    for what, adb in (("scene clamp", scene.disp_bounds[v0]),
                      ("open clamp", a_db_open)):
        want = row_gather_affine_plain(a_src, a_abc, a_dxs, float(corner),
                                       adb, corner)
        got = row_gather_affine_cuda(a_src, a_abc, a_dxs, float(corner),
                                     adb, corner)
        max_err_affine = max(max_err_affine, bit_equal(
            got, want, f"K=4 x {len(a_dxs)} columns, {what}, src "
                       f"{tuple(a_src.shape)} -> {tuple(got.shape)}",
            "row_gather_affine"))
        del want, got
    # The rows launches of the census path on view 0: all window rows of
    # the sparse pass (K=4 x 9 rows x 9 columns, the planes above) and of
    # the full pass (K=1 x 11 x 11, with a NaN plane), against the stack of
    # one-row plain calls.
    a_abc1 = abc_of(1, "pair").clone()
    a_abc1[0, 0, 3, 5] = float("nan")
    cull_hrad = jparams.cull_box // 2
    rows_cases = {   # label -> (abc, dxs = dys)
        "sparse": (a_abc, tuple(range(-cull_hrad, cull_hrad + 1))),
        "full": (a_abc1, a_dxs)}
    for label, (rabc, rdx) in rows_cases.items():
        want = row_gather_affine_rows_plain(a_src, rabc, rdx, rdx,
                                            scene.disp_bounds[v0])
        got = row_gather_affine_rows_cuda(a_src, rabc, rdx, rdx,
                                          scene.disp_bounds[v0])
        max_err_affine = max(max_err_affine, bit_equal(
            got, want, f"rows launch ({label}): K={rabc.shape[0]} x "
                       f"{len(rdx)} rows x {len(rdx)} columns -> "
                       f"{tuple(got.shape)}", "row_gather_affine"))
        del want, got
    torch.cuda.synchronize()

    # ---- 4. the paths -----------------------------------------------------
    interior = (slice(16, -16), slice(16, -16))
    runs = {}
    split = {}
    for label in paths:
        stamp(f"path {label}: compute_depthmap")
        # No other thread uses the card during the one-level scan paths'
        # captures, so a host sync inside one is made an error there.
        tpmm.CAPTURE_SYNC_DEBUG_MODE = (
            "error" if label in ("rect_scan", "exact_scan") else "default")
        tpmm.SCAN_LOG.clear()
        kernels.reset_counts()
        t0 = time.perf_counter()
        if label == "cull_downscale":
            res, split = run_split(torch, paths[label], images, Ps, device)
        else:
            res = compute_depthmap(images, Ps, paths[label], device=device)
        e2e_s = time.perf_counter() - t0
        launches = dict(kernels.counts)
        tpmm.CAPTURE_SYNC_DEBUG_MODE = "default"
        err = abs(res.depth[interior] - gt[interior]) / gt[interior]
        med = float(np.median(err))
        gate = 5e-3
        if label in RELATIVE_GATES:
            ref, factor = RELATIVE_GATES[label]
            gate = factor * runs[ref]["med"]
        log(f"  median rel depth err {med:.5f} "
            f"({'not gated' if label in UNGATED else f'gate < {gate:.3g}'}),"
            f" run {res.runtime_s:.3f} s, end to end {e2e_s:.3f} s, "
            f"launches {launches}"
            + (f", CUDA graphs {tpmm.SCAN_LOG}" if tpmm.SCAN_LOG else ""))
        if label in SCAN_PATHS and not tpmm.SCAN_LOG:
            fail(f"{label}: no level ran as a CUDA graph")
        if not (np.isfinite(res.depth).all() and res.depth.shape == gt.shape):
            fail(f"{label}: depth map not finite or of the wrong shape")
        if label not in UNGATED and not med < gate:
            fail(f"{label}: quality gate: median rel depth err {med} "
                 f"(gate {gate})")
        missing = [k for k in PATH_KERNELS[label] if launches[k] <= 0]
        if missing:
            fail(f"{label}: kernels of the path never launched: {missing}")
        if label in SAMPLER_TILED_SHARE:
            tiled = (launches["bilinear_sample_tiled"]
                     / launches["bilinear_sample"])
            log(f"  sampler launches on a tile: {tiled:.4f}")
            if tiled != SAMPLER_TILED_SHARE[label]:
                fail(f"{label}: {tiled} of the sampler's launches took a "
                     f"tile, not {SAMPLER_TILED_SHARE[label]}")
        runs[label] = dict(med=med, e2e_s=e2e_s, launches=launches, res=res)
    res = runs["rect"]["res"]
    with tempfile.TemporaryDirectory() as td:
        write_outputs(res, td, params, ref_image=images[0],
                      P_ref=rig.cameras[0].P)
        got_files = sorted(os.listdir(td))
    want_files = sorted(["disp.dmb", "normals.dmb", "disp.png",
                         "normals.png", "cost.png", "results.txt",
                         f"3d_model_{res.ref_name}.ply"])
    if got_files != want_files:
        fail(f"write_outputs artifacts {got_files} != {want_files}")
    log(f"  artifacts: {got_files}")

    # ---- 4c. (e) the nested cull scene's kernels --------------------------
    stamp("(e) cull_downscale: kernels on the nested cull scene")
    log(f"  launches by pass: {json.dumps(split)}")
    if not split.get("sparse_nested", {}).get("sdg_fused_cost"):
        fail("cull_downscale: no sparse pass ran on a nested grid")
    # Prep with every level built, beside the same pyramid without it.
    for label, key in (("pyramid", "pyramid_resolved"),
                       ("cull_downscale", "cull_downscale")):
        t0 = time.perf_counter()
        pj = prepare_job(images, Ps, paths[label], device=device)
        for f in pj.prep:
            f.result()
        prep_s[key] = time.perf_counter() - t0
    jobs["cull_downscale"] = pj
    err_p_nested, err_f_nested, nested, nested_case = nested_kernel_checks(
        torch, jobs["cull_downscale"], device)
    max_err_perm = max(max_err_perm, err_p_nested)
    max_err_fused = max(max_err_fused, err_f_nested)
    torch.cuda.synchronize()

    # ---- 4d. (f) the scan against the host loop ---------------------------
    stamp("(f) level_dispatch='scan' against the host loop")
    for label, host in SCAN_PATHS.items():
        a, b = runs[label]["res"], runs[host]["res"]
        same = all(np.array_equal(np.asarray(x).view(np.int32),
                                  np.asarray(y).view(np.int32))
                   for x, y in ((a.depth, b.depth), (a.normals, b.normals),
                                (a.cost, b.cost)))
        log(f"  {label} vs {host}: depth, normals and cost "
            f"{'bit-equal' if same else 'DIFFER'}; launches "
            f"{runs[label]['launches']} vs {runs[host]['launches']}")
        if not same:
            fail(f"{label}: differs from the host loop ({host})")
    # A registered generator draws, on every replay, the next uniforms of
    # its stream (what an eager call draws), not the captured ones again.
    g_gen = torch.Generator(device=device).manual_seed(9)
    g_ref = torch.Generator(device=device).manual_seed(9)
    g_out = torch.empty(1 << 16, device=device)
    torch.rand(g_out.numel(), generator=g_gen, device=device)
    torch.rand(g_out.numel(), generator=g_ref, device=device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g_gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        g_out.copy_(torch.rand(g_out.numel(), generator=g_gen, device=device))
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    draws = []
    for _ in range(3):
        graph.replay()
        draws.append(g_out.clone())
    eager_same = all(torch.equal(d, torch.rand(g_out.numel(), generator=g_ref,
                                               device=device)) for d in draws)
    distinct = not any(torch.equal(draws[i], draws[j])
                       for i in range(3) for j in range(i))
    log(f"  graph replays of torch.rand: distinct {distinct}, equal to the "
        f"eager stream {eager_same}")
    if not (distinct and eager_same):
        fail("a generator registered with a CUDA graph repeats or departs "
             "from its stream across replays")
    del graph, draws, g_out

    # ---- 4e. (g) parity ---------------------------------------------------
    stamp("(g) eval/parity on the card")
    parity_phase(device, card)

    # ---- 4f. (h) native IO ------------------------------------------------
    stamp("(h) native IO")
    native_io_phase(np, runs["rect"]["res"], images[0], rig.cameras[0].P)

    # ---- 4g. (i) the parallel layer: several ranks on the card ---------
    bench = DistBench(torch, np, device, images, rig, gt, Ps, paths["exact"])
    dist_lines = dist_bench_phase(torch, card, bench)

    # ---- 4b. the scripts' path: a folder of views, CLI, fusion ----------
    # (then (i2), (i4) and (i5) in one 2-rank world, (i5) over that folder
    # against batch run (a))
    with tempfile.TemporaryDirectory() as td:
        folder = batch_folder(np, td)
        batch = batch_phase(torch, np, device, card, folder)
        dist_lines.update(dist_pair_phase(torch, np, card, bench, folder))
    if sorted(dist_lines) != ["i1", "i2", "i3", "i4", "i5"]:
        fail(f"(i) sub-runs missing: ran {sorted(dist_lines)}")

    # ---- 5. timings ----------------------------------------------------------
    stamp("timings")
    for label in ("pyramid", "census", "unfused", "monolithic", "rect_scan",
                  "pyramid_scan", "exact_scan"):
        t0 = time.perf_counter()
        jobs[label] = prepare_job(images, Ps, paths[label], device=device)
        prep_s[label] = time.perf_counter() - t0
    prof, moved, warm, dev_info = {}, {}, {}, {}
    mp = h * w / 1e6
    gc_s = [0.0, None]

    def gc_clock(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        elif gc_s[1] is not None:
            gc_s[0] += time.perf_counter() - gc_s[1]
    gc.callbacks.append(gc_clock)
    for label in (lb for lb in paths if lb != "census_exact"):
        # A warm run of the path (the pyramid's first run resolves its
        # background scene builds; this second one reuses them).  The
        # collection owed by earlier phases (the profiled runs' events) is
        # made before the timed span: one fell inside the monolithic warm
        # run, 1.27 s of its 1.93 s on an H100 80GB HBM3 at 700 W.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        tpmm.SCAN_LOG.clear()
        m0 = torch.cuda.memory_stats()
        gc_s[0] = 0.0
        t0 = time.perf_counter()
        res2 = run_prepared_job(jobs[label])
        run_s = time.perf_counter() - t0
        m1 = torch.cuda.memory_stats()
        warm[label] = dict(runtime_s=res2.runtime_s,
                           peak_GB=torch.cuda.max_memory_allocated() / 1e9,
                           graphs=list(tpmm.SCAN_LOG))
        log(json.dumps({"metric": "path", "path": label, "card": card,
                        "e2e_first_s": runs[label]["e2e_s"],
                        "first_runtime_s": runs[label]["res"].runtime_s,
                        "prep_s": prep_s[label], "run_s": run_s,
                        "runtime_s": res2.runtime_s,
                        "MP_per_s": mp / res2.runtime_s,
                        "median_rel_err": runs[label]["med"],
                        "launches": dict(kernels.counts),
                        "gc_s": gc_s[0],
                        "device_allocs": m1.get("num_device_alloc", 0)
                        - m0.get("num_device_alloc", 0),
                        "alloc_retries": m1["num_alloc_retries"]
                        - m0["num_alloc_retries"],
                        "reserved_GB": torch.cuda.memory_reserved() / 1e9,
                        "peak_allocated_GB": warm[label]["peak_GB"],
                        "cuda_graphs": warm[label]["graphs"],
                        "threads": threading.active_count()}))
        prof[label], moved[label], dev_info[label] = profile_path(
            torch, jobs[label], card, res2.runtime_s, label)
        stamp(f"profiled {label}")
    gc.callbacks.remove(gc_clock)

    # (e) beside the pyramid without cull_downscale; (f) beside the host
    # loop.  Device seconds and busy share of the profiled runs; warm runs
    # in turns (the host's clock wanders between phases: the rect warm run
    # above read 0.69 s and 1.46 s in one call).
    turns = {lb: alternate(torch, jobs[ref], jobs[lb])
             for lb, ref in (("cull_downscale", "pyramid"),
                             *SCAN_PATHS.items())}
    nested_shape = tuple(nested.ref_rect.shape)
    log(json.dumps({
        "metric": "cull_downscale", "card": card,
        "nested_grid": nested_shape,
        "full_grid": tuple(jobs["cull_downscale"].prep[-1].result()[0]
                           .ref_rect.shape),
        "launches_by_pass": split,
        "prep_s": prep_s["cull_downscale"],
        "prep_s_pyramid": prep_s["pyramid_resolved"],
        "warm_runs_in_turns_s": turns["cull_downscale"][1],
        "warm_runs_in_turns_s_pyramid": turns["cull_downscale"][0],
        "device": dev_info["cull_downscale"],
        "device_pyramid": dev_info["pyramid"],
        "median_rel_err": runs["cull_downscale"]["med"],
        "median_rel_err_pyramid": runs["pyramid"]["med"]}))
    for label, host in SCAN_PATHS.items():
        log(json.dumps({
            "metric": "scan_vs_host", "path": label, "host_path": host,
            "card": card, "warm_runs_in_turns_s": turns[label][1],
            "warm_runs_in_turns_s_host": turns[label][0],
            "capture_s": [g["capture_s"] for g in warm[label]["graphs"]],
            "replays": [g["replays"] for g in warm[label]["graphs"]],
            "device": dev_info[label], "device_host": dev_info[host],
            "peak_allocated_GB": warm[label]["peak_GB"],
            "peak_allocated_GB_host": warm[host]["peak_GB"],
            "launches": runs[label]["launches"],
            "launches_host": runs[host]["launches"]}))

    def per_launch_ms(label, name):
        ms, n = prof[label].get(name, (0.0, 0))
        return ms / n if n else "not measured"

    launches = {k: runs[p]["launches"][k]
                for p, k in (("rect", "row_gather_nearest"),
                             ("rect", "permute2d"),
                             ("rect", "sdg_fused_cost"),
                             ("exact", "bilinear_sample"),
                             ("exact", "exact_window_cost"),
                             ("exact", "exact_warp_coords"),
                             ("f32", "row_gather_lerp"),
                             ("census", "row_gather_affine"))}

    gsrc, gx = fwd_src_pair, scene.fwd_c1[v0][None].contiguous()
    gmask = fwd_t[2]
    gC, gH, gW = gsrc.shape
    gB, _, gWs = gx.shape
    on_tiles = int(gmask.sum())
    rows_on = int((gmask.sum(1) > 0).sum()) * 8
    g_bytes = (4 * on_tiles * 8 * 128 * gB * (1 + gC)
               + 4 * gC * min(rows_on, gH) * gW)
    g_bound = g_bytes / HBM_BPS * 1e3
    g_ms = graph_ms(lambda: row_gather_nearest_cuda(gsrc, gx, gmask))
    g_plain = graph_ms(lambda: row_gather_nearest_plain(gsrc, gx))
    idx = ((gx.clamp(0, gW - 1) + 0.5).to(torch.int64).clamp(0, gW - 1)
           [:, None].expand(gB, gC, gH, gWs))
    gsrc_b = gsrc[None].expand(gB, gC, gH, gW)
    g_lib = graph_ms(lambda: torch.gather(gsrc_b, 3, idx))
    g_line = {"kernel": "row_gather_nearest", "card": card,
              "shape": f"fwd pass1 src {tuple(gsrc.shape)} int32, x "
                       f"{tuple(gx.shape)}, mask {tuple(gmask.shape)}",
              "ms": g_ms, "plain_ms": g_plain, "library_ms": g_lib,
              "bound_ms": g_bound, "bound_by": "bytes",
              "launches": launches["row_gather_nearest"],
              "main_path_ms_per_launch": "off the main path"}
    log(json.dumps(g_line))

    # permute2d at the forward permutation of the full pass (K=1 plane
    # pairs) and at the return permutation (an f32 cost), both masks on,
    # beside the two-pass chain it replaced (two nearest gathers, the
    # intermediate's and the table's transposes, and the copy of the
    # transposed result the caller made) and one PyTorch call for the same
    # gather (index_select at the composite flat index, precomputed).
    perm_lines = {}
    for label, (px, pc1, pr, pm1, pm2) in (
            ("fwd", (fwd_src_pair, *fwd_t)), ("ret", (cost_src, *ret_t))):
        p_bound, p_bytes = permute_bound(torch, px, pc1, pr, pm2)
        p_ms = graph_ms(lambda: permute2d_cuda(px, pc1, pr, pm2))
        p_plain = graph_ms(lambda: permute2d_plain(px, pc1, pr))

        def two_pass():
            a = row_gather_nearest_cuda(px, pc1[None], pm1)[0]
            o = row_gather_nearest_cuda(a.transpose(1, 2).contiguous(),
                                        pr.t().contiguous()[None], pm2)[0]
            return o.transpose(1, 2).contiguous()

        p_chain = graph_ms(two_pass)
        p_idx = permute2d_index(pc1, pr, *px.shape[1:]).reshape(-1)
        pxf = px.flatten(1)
        p_lib = graph_ms(lambda: pxf.index_select(1, p_idx))
        perm_lines[label] = {
            "kernel": "permute2d", "card": card,
            "shape": f"{label} x {tuple(px.shape)} {px.dtype} -> "
                     f"{(px.shape[0], *pr.shape)}, masks "
                     f"{tuple(pm1.shape)} {tuple(pm2.shape)}",
            "ms": p_ms, "two_pass_chain_ms": p_chain, "plain_ms": p_plain,
            "library_ms": p_lib, "bound_ms": p_bound, "bound_by": "bytes",
            "bound_bytes": p_bytes, "launches": launches["permute2d"],
            "main_path_ms_per_launch": per_launch_ms("rect", "permute2d")}
        log(json.dumps(perm_lines[label]))
        del p_idx, pxf

    # The fused cost at the full pass's shape (K=1, box 11 / inc 2) and
    # the cull pass's (K=4, box 9 / inc 4), each beside its own bound.
    C = ref_v.shape[0] // 3
    npx = int(cov.sum())
    fused_lines = {}
    for label, want_what in (("full", "K=1 box11/inc2"),
                             ("cull", "K=4 cull box9/inc4")):
        _, fp, fabc = next(c for c in fused_cases if c[0] == want_what)[:3]
        K = fabc.shape[0]
        f_bound, f_by, f_ops, f_bytes = fused_bound(fp, K, C, npx)
        f_ms = graph_ms(lambda: fused_sdg_cost_batch_cuda(
            ref_v, src_v, fabc, fp, db_v, hw_v, tm_v))
        f_plain = graph_ms(lambda: fused_sdg_cost_batch_plain(
            ref_v, src_v, fabc, fp, db_v[0], db_v[1]), reps=3, rounds=3)
        fused_lines[label] = {
            "kernel": "sdg_fused_cost", "card": card,
            "shape": f"K={K} box {fp.box_hsize}/inc {fp.window_increment}, "
                     f"ref {tuple(ref_v.shape)}, {npx} covered px",
            "ms": f_ms, "plain_ms": f_plain, "library_ms": None,
            "bound_ms": f_bound, "bound_by": f_by, "bound_ops": f_ops,
            "bound_bytes": f_bytes,
            "bound_counts": "FP32 operations of the plain version's "
                            "arithmetic (chip_smoke OPS_*): per candidate "
                            "and covered pixel T*E positions x (8 + 3C) + "
                            "E + 2T + 2 + NROW*NCOL contributions x (11C + "
                            "6, +1 at C>1); per pixel NROW*NCOL weights x "
                            "(2C + 1), shared by the K candidates; at 67 "
                            "TFLOP/s, against each input word once at "
                            "3.35 TB/s",
            "ops_per_candidate_px": f_ops / (K * npx),
            "launches": launches["sdg_fused_cost"],
            "main_path_ms_per_launch": per_launch_ms("rect",
                                                     "sdg_fused_cost")}
        log(json.dumps(fused_lines[label]))
    f_line = fused_lines["full"]
    # The fused cost at the nested cull scene's shape (cull_downscale=2:
    # the finest level's first nested view, K=4, cull box 9 / inc 4).
    nref, nsrc, nabc, nsp, ndb, nhw, ntm, nnpx = nested_case
    n_bound, n_by, _, _ = fused_bound(nsp, 4, nref.shape[0] // 3, nnpx)
    fused_lines["nested"] = {
        "kernel": "sdg_fused_cost", "card": card,
        "shape": f"K=4 box {nsp.box_hsize}/inc {nsp.window_increment}, "
                 f"nested ref {tuple(nref.shape)}, {nnpx} covered px",
        "ms": graph_ms(lambda: fused_sdg_cost_batch_cuda(
            nref, nsrc, nabc, nsp, ndb, nhw, ntm)),
        "plain_ms": graph_ms(lambda: fused_sdg_cost_batch_plain(
            nref, nsrc, nabc, nsp, ndb[0], ndb[1]), reps=3, rounds=3),
        "library_ms": None, "bound_ms": n_bound, "bound_by": n_by,
        "launches": runs["cull_downscale"]["launches"]["sdg_fused_cost"],
        "main_path_ms_per_launch": per_launch_ms("cull_downscale",
                                                 "sdg_fused_cost")}
    log(json.dumps(fused_lines["nested"]))

    # The sampler at the exact path's largest launch: view 0, K=4
    # propagation candidates x 36 offsets.  Bound: per sample 8 B of
    # coordinates in and 4*C3 B out, the source read once, at HBM rate.
    sC3 = s_src.shape[0]
    n_smp = sx.numel()
    s_bytes = n_smp * (8 + 4 * sC3) + 4 * s_src.numel()
    s_bound = s_bytes / HBM_BPS * 1e3
    s_ms_k = graph_ms(lambda: bilinear_sample_cuda(s_src, sx, sy), reps=10)
    s_plain = graph_ms(lambda: bilinear_sample_plain(s_src, sx, sy),
                       reps=3, rounds=3)
    grid = torch.stack([sx / (xW - 1) * 2 - 1, sy / (xH - 1) * 2 - 1],
                       dim=-1).reshape(1, -1, sx.shape[-1], 2)
    s_in = s_src[None]
    s_lib = graph_ms(lambda: torch.nn.functional.grid_sample(
        s_in, grid, mode="bilinear", padding_mode="border",
        align_corners=True), reps=10)
    del grid
    s_routes = {r: graph_ms(lambda: bilinear_sample_on_route(
        s_src, sx, sy, r), reps=10) for r in (0, sampler_route(len(sx)))}
    s_line = {"kernel": "bilinear_sample", "card": card,
              "shape": f"src {tuple(s_src.shape)} f32, coords "
                       f"{tuple(sx.shape)} (K=4 x {len(offs)} offsets)",
              "clamped_share": clamped_share(torch, sx, sy, xH, xW),
              "route": sampler_route(len(sx)), "ms_by_route": s_routes,
              "ms": s_ms_k, "graph_ms": s_ms_k, "plain_ms": s_plain,
              "library_ms": s_lib, "bound_ms": s_bound, "bound_by": "bytes",
              "launches": launches["bilinear_sample"],
              "main_path_ms_per_launch": per_launch_ms("exact",
                                                       "bilinear_sample")}
    log(json.dumps(s_line))

    x_lines = exact_cost_lines(torch, card)
    for ln in x_lines.values():
        ln["launches"] = launches["exact_window_cost"]
        ln["main_path_ms_per_launch"] = per_launch_ms("exact",
                                                      "exact_window_cost")
        log(json.dumps(ln))
    x_line = x_lines["dtu_fast"]
    w_lines = exact_warp_lines(torch, card)
    for ln in w_lines.values():
        ln["launches"] = launches["exact_warp_coords"]
        ln["main_path_ms_per_launch"] = per_launch_ms("exact",
                                                      "exact_warp_coords")
        log(json.dumps(ln))
    w_line = w_lines["dtu_fast"]
    f_lines = sampler_field_lines(torch, card)
    for ln in f_lines.values():
        log(json.dumps(ln))

    # The lerp gather in its three modes, at the shapes of the kernel phase.
    # Bound: each input read once (x, 4 B per position; the source, 4 B per
    # word) and each output written once (4 B per position and output
    # channel), at HBM rate; the taps a sample reads again come from
    # L1/L2.  Library: grid_sample with y on the (shifted) row computes the
    # f32 mode's function; PACKED / GFWD have none.
    lerp_lines = {}
    for label, (mode, lsrc, lx, gfwd, _) in lerp_cases.items():
        lC, lh, lw = lsrc.shape
        npos = lx.numel()
        co = lC + lC // 2 if gfwd else lC
        l_bytes = npos * (4 + co * 4) + 4 * lsrc.numel()
        l_ms = graph_ms(lambda: row_gather_lerp_cuda(lsrc, lx, gfwd, corner))
        l_plain = graph_ms(lambda: row_gather_lerp_plain(lsrc, lx, gfwd,
                                                         corner),
                           reps=3, rounds=3)
        l_lib = None
        if mode == "f32":
            rows = (torch.arange(lh, device=device) + corner).clamp(0, lh - 1)
            gy = (rows.to(torch.float32) / (lh - 1) * 2 - 1)[None, :, None]
            lgrid = torch.stack([lx / (lw - 1) * 2 - 1,
                                 gy.expand_as(lx)], dim=-1).contiguous()
            lin = lsrc[None].expand(lx.shape[0], lC, lh, lw).contiguous()
            l_lib = graph_ms(lambda: torch.nn.functional.grid_sample(
                lin, lgrid, mode="bilinear", padding_mode="border",
                align_corners=True), reps=10)
            del lgrid, lin
        lerp_lines[label] = {
            "kernel": "row_gather_lerp", "mode": mode, "card": card,
            "shape": f"src {tuple(lsrc.shape)} {lsrc.dtype}, x "
                     f"{tuple(lx.shape)}",
            "ms": l_ms, "plain_ms": l_plain, "library_ms": l_lib,
            "bound_ms": l_bytes / HBM_BPS * 1e3, "bound_by": "bytes",
            "launches": runs[label]["launches"]["row_gather_lerp"],
            "main_path_ms_per_launch": per_launch_ms(label,
                                                     "row_gather_lerp")}
        log(json.dumps(lerp_lines[label]))

    # The affine gather at the census path's largest row launch.  Bound:
    # abc 12 B per (k, pixel), 4 B out per (k, e, c, pixel), the source
    # once, at HBM rate; no library call computes it.
    aK, _, ah, aw = a_abc.shape
    aC = a_src.shape[0]
    a_bytes = (12 * aK * ah * aw + 4 * aK * len(a_dxs) * aC * ah * aw
               + 4 * a_src.numel())
    a_db = scene.disp_bounds[v0]
    a_ms = graph_ms(lambda: row_gather_affine_cuda(
        a_src, a_abc, a_dxs, float(corner), a_db, corner))
    a_plain = graph_ms(lambda: row_gather_affine_plain(
        a_src, a_abc, a_dxs, float(corner), a_db, corner), reps=3, rounds=3)

    def path_bound_ms(label):
        # Per launch of the profiled run: the bytes its launches must move,
        # summed by the wrapper from each launch's own shape, at HBM rate.
        n, nbytes = moved[label].get("row_gather_affine", (0, 0))
        return nbytes / n / HBM_BPS * 1e3 if n else "not measured"

    a_line = {"kernel": "row_gather_affine", "card": card,
              "shape": f"src {tuple(a_src.shape)} int32, abc "
                       f"{tuple(a_abc.shape)}, {len(a_dxs)} columns",
              "ms": a_ms, "plain_ms": a_plain, "library_ms": None,
              "bound_ms": a_bytes / HBM_BPS * 1e3, "bound_by": "bytes",
              "launches": launches["row_gather_affine"],
              "launches_unfused": runs["unfused"]["launches"][
                  "row_gather_affine"],
              "main_path_ms_per_launch": per_launch_ms("census",
                                                       "row_gather_affine"),
              "main_path_bound_ms_per_launch": path_bound_ms("census"),
              "unfused_ms_per_launch": per_launch_ms("unfused",
                                                     "row_gather_affine"),
              "unfused_bound_ms_per_launch": path_bound_ms("unfused")}
    log(json.dumps(a_line))

    # The rows launches of the kernel phase, beside the same rows as one-row
    # launches of this kernel.  Bound: abc once, every row's output, the
    # source once.
    rows_lines = {}
    for label, (rabc, rdx) in rows_cases.items():
        rK = rabc.shape[0]
        r_bytes = 4 * (3 * rK * ah * aw + len(rdx) * rK * len(rdx) * aC
                       * ah * aw + a_src.numel())
        r_ms = graph_ms(lambda: row_gather_affine_rows_cuda(
            a_src, rabc, rdx, rdx, a_db), reps=5)
        r_one = graph_ms(lambda: [row_gather_affine_cuda(
            a_src, rabc, rdx, float(d), a_db, d) for d in rdx], reps=2)
        r_plain = graph_ms(lambda: row_gather_affine_rows_plain(
            a_src, rabc, rdx, rdx, a_db), reps=1, rounds=3)
        rows_lines[label] = {
            "kernel": "row_gather_affine", "launch": f"rows ({label})",
            "card": card,
            "shape": f"K={rK} x {len(rdx)} rows x {len(rdx)} columns, src "
                     f"{tuple(a_src.shape)} -> "
                     f"{(len(rdx), rK * len(rdx), aC, ah, aw)}",
            "ms": r_ms, "one_row_launches_ms": r_one, "plain_ms": r_plain,
            "library_ms": None, "bound_ms": r_bytes / HBM_BPS * 1e3,
            "bound_by": "bytes"}
        log(json.dumps(rows_lines[label]))

    # ---- 6. summary lines -----------------------------------------------
    stamp("summary")
    kernel_rows = [
        {"name": "row_gather_nearest", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/rowgather.cu",
         "replaces": "gipuma_tpu/ops/pallas_rowgather.py:40",
         "launches": launches["row_gather_nearest"],
         "max_abs_err": max_err_gather,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": "bytes", "library_ms": g_lib},
        {"name": "permute2d", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/permute2d.cu",
         "replaces": "gipuma_tpu/ops/pallas_rowgather.py:40",
         "launches": launches["permute2d"],
         "max_abs_err": max_err_perm, "ms": perm_lines["fwd"]["ms"],
         "plain_ms": perm_lines["fwd"]["plain_ms"],
         "bound_ms": perm_lines["fwd"]["bound_ms"], "bound_by": "bytes",
         "library_ms": perm_lines["fwd"]["library_ms"],
         "two_pass_chain_ms": perm_lines["fwd"]["two_pass_chain_ms"]},
        {"name": "sdg_fused_cost", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/sdg_fused.cu",
         "replaces": "gipuma_tpu/ops/pallas_sdg_fused.py:73",
         "launches": launches["sdg_fused_cost"],
         "max_abs_err": max_err_fused, "ms": f_line["ms"],
         "plain_ms": f_line["plain_ms"], "bound_ms": f_line["bound_ms"],
         "bound_by": f_line["bound_by"], "library_ms": None,
         "cull_shape": {k: fused_lines["cull"][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by")},
         "nested_cull_shape": {k: fused_lines["nested"][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "bilinear_sample", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/sampling.cu",
         "replaces": "gipuma_tpu/ops/pallas_sampling.py:61",
         "launches": launches["bilinear_sample"],
         "max_abs_err": max_err_sample, "ms": s_ms_k, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": "bytes", "library_ms": s_lib,
         "ms_by_route": s_routes,
         "dtu_unit": {k: {f: ln[f] for f in (
             "clamped_share", "route", "ms_by_route", "bound_ms")}
             for k, ln in f_lines.items()}},
        {"name": "exact_window_cost", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/exact_cost.cu",
         "replaces": "port-only: no Pallas counterpart; the JAX package's "
                     "XLA offset scan (gipuma_tpu/ops/cost.py:146-215)",
         "launches": launches["exact_window_cost"],
         "max_abs_err": max(ln["max_abs_err"] for ln in x_lines.values()),
         "ms": x_line["ms"], "plain_ms": x_line["plain_ms"],
         "bound_ms": x_line["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "shapes": {k: {f: ln[f] for f in (
             "shape", "ms", "plain_ms", "bound_ms", "max_abs_err")}
             for k, ln in x_lines.items()}},
        {"name": "exact_warp_coords", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/exact_cost.cu",
         "replaces": "port-only: no Pallas counterpart; the position "
                     "arithmetic of the JAX package's XLA offset scan "
                     "(gipuma_tpu/ops/cost.py:146-215)",
         "launches": launches["exact_warp_coords"], "max_abs_err": 0.0,
         "ms": w_line["ms"], "plain_ms": w_line["plain_ms"],
         "bound_ms": w_line["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "shapes": {k: {f: ln[f] for f in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_share")}
             for k, ln in w_lines.items()}},
        # The f32 mode, the one a library call computes; every mode's
        # numbers are in "modes" (and in the row_gather_lerp lines above).
        {"name": "row_gather_lerp", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/rowgather_lerp.cu",
         "replaces": "gipuma_tpu/ops/pallas_rowgather.py:40",
         "launches": launches["row_gather_lerp"],
         "max_abs_err": max_err_lerp, "ms": lerp_lines["f32"]["ms"],
         "plain_ms": lerp_lines["f32"]["plain_ms"],
         "bound_ms": lerp_lines["f32"]["bound_ms"], "bound_by": "bytes",
         "library_ms": lerp_lines["f32"]["library_ms"],
         "modes": {ln["mode"]: {k: ln[k] for k in (
             "launches", "ms", "plain_ms", "bound_ms", "library_ms")}
             for ln in lerp_lines.values()}},
        {"name": "row_gather_affine", "route": "cuda",
         "source": "gipuma_tpu_torch/csrc/rowgather_affine.cu",
         "replaces": "gipuma_tpu/ops/pallas_rowgather.py:331",
         "launches": launches["row_gather_affine"],
         "max_abs_err": max_err_affine, "ms": a_ms, "plain_ms": a_plain,
         "bound_ms": a_line["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "main_path_ms_per_launch": a_line["main_path_ms_per_launch"],
         "main_path_bound_ms_per_launch": a_line[
             "main_path_bound_ms_per_launch"],
         "rows_launches": {k: {f: ln[f] for f in (
             "shape", "ms", "one_row_launches_ms", "plain_ms", "bound_ms")}
             for k, ln in rows_lines.items()}},
    ]
    # Launches in the batch phase's runs, (d) being the monolithic path.
    batch["d"] = runs["monolithic"]["launches"]
    for row in kernel_rows:
        row["batch_launches"] = {r: ln[row["name"]]
                                 for r, ln in sorted(batch.items())}
        # The paths of this slice: cull_downscale and the scan paths (their
        # counts include every CUDA-graph replay), with the profiled device
        # time per launch where the path runs the kernel.
        row["new_path_launches"] = {
            lb: runs[lb]["launches"][row["name"]]
            for lb in ("cull_downscale", *SCAN_PATHS)}
        # Phase (i)'s sharded runs: the kernel's launches on each rank.
        row["dist_launches"] = {
            lb: [ranks.get(row["name"], 0) for ranks in ln["launches"]]
            for lb, ln in dist_lines.items()}
        row["new_path_ms_per_launch"] = {
            lb: per_launch_ms(lb, row["name"])
            for lb in ("cull_downscale", *SCAN_PATHS)
            if row["name"] in PATH_KERNELS[lb]}
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
