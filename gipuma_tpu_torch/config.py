"""Algorithm configuration of the PyTorch port.

A field-for-field copy of ``gipuma_tpu/config.py`` (the JAX package's
module imports JAX through its package ``__init__``, so the port keeps its
own copy).  Every field, default and preset is identical; the port's tests
hold the two against each other.  Fields that tune only the TPU kernels
(``fused_roll``, ``fused_block_rows``, ``use_pallas_sampler``) are accepted
and have no effect on the port's output.  The port runs every setting the
JAX package runs on one device.

All defaults mirror the reference defaults exactly.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class CostCombination(enum.IntEnum):
    """Multi-view cost combination mode (reference: algorithmparameters.h:17)."""

    ALL = 0
    BEST_N = 1
    ANGLE = 2  # parsed by the reference CLI but unimplemented on device
    GOOD = 3


class MatchingAlgorithm(enum.IntEnum):
    """Photometric cost family (reference: algorithmparameters.h:5-14).

    Only PM (bilaterally weighted color+gradient) and CENSUS exist on the
    reference device path; the remaining enum values are parsed but dead
    (SURVEY.md §2.2, "dead code" list).
    """

    PM = 0
    CENSUS = 1


# Reference: config.h:22 — per-view costs at or above this value are invalid.
MAXCOST = 1000.0


@dataclasses.dataclass(frozen=True)
class AlgorithmParams:
    """All runtime tunables (frozen, so instances hash)."""

    # --- matching cost (reference defaults: algorithmparameters.h:21-51) ---
    algorithm: MatchingAlgorithm = MatchingAlgorithm.PM
    box_hsize: int = 19          # window width  (pixels)
    box_vsize: int = 19          # window height (pixels)
    tau_color: float = 10.0      # color difference truncation
    tau_gradient: float = 2.0    # gradient difference truncation
    alpha: float = 0.9           # color/gradient blend weight
    gamma: float = 10.0          # bilateral weight falloff
    window_increment: int = 2    # sample every k-th window pixel (gipuma.cu:28)
    census_epsilon: float = 2.5

    # --- cost aggregation over views ---
    cost_comb: CostCombination = CostCombination.BEST_N
    n_best: int = 2
    good_factor: float = 1.5

    # --- PatchMatch schedule ---
    iterations: int = 8
    # Propagation variants (reference compile-time EXTRAPOINT/EXTRAPOINTFAR,
    # gipuma.cu:36-38). The default reference build is SMALLKERNEL: a
    # close sweep (±1), a far sweep (±5), and a refinement sweep.
    far_propagation: bool = True       # ±5 "surface normal diffusion" sweep
    # "small": separate close (±1) / far (±5) sweeps — the reference's
    # default SMALLKERNEL + EXTRAPOINTFAR build (gipuma.cu:25-38).
    # "monolithic": one sweep with ±1/±3/±5 axial plus the EXTRAPOINT2
    # diagonal offsets (gipuma_checkerboard_cu, gipuma.cu:1122-1351).
    propagation_variant: str = "small"
    refine: bool = True                # disable for propagation-only ablations
    refine_delta_z_floor: float = 0.01  # gipuma.cu:959 loop lower bound
    refine_delta_z_div: float = 10.0    # gipuma.cu:959 deltaZ shrink factor
    refine_delta_n_init: float = 1.0    # gipuma.cu:945
    refine_delta_n_div: float = 4.0     # gipuma.cu:992

    # --- depth / disparity range ---
    depth_min: float = -1.0  # -1 → derive from view-selection baselines
    depth_max: float = -1.0
    min_disparity: float = 0.0
    max_disparity: float = 256.0

    # --- view selection (reference: main.cpp:430-499) ---
    view_selection: bool = True
    min_angle: float = 5.0   # degrees
    max_angle: float = 45.0  # degrees
    max_views: int = 9

    # --- misc ---
    color_processing: bool = False
    cam_scale: float = 1.0
    no_texture_check: bool = False  # reference NOTEXTURE_CHECK (gipuma.cu:34)
    no_texture_sim: float = 0.9
    no_texture_per: float = 0.6
    cost_thresh: float = 40.0  # validity threshold for outputs/fusion
    seed: int = 0              # replaces curand clock64() seeding — deterministic
    # The fields below select and tune the JAX package's fast paths; the
    # history and the measurements behind each default are in
    # gipuma_tpu/config.py.  The port runs every rect layout the JAX
    # package has: window_grads (fused or not), grad_fwd, full channels
    # and f32 taps, PM or census, with or without cull_downscale.
    # The JAX package's choice between two samplers of the exact path (the
    # Pallas kernel or an XLA gather) that compute the same function.
    # Accepted; no effect here: the port has one sampler, the CUDA kernel
    # of ops/sampling.py, whichever is set.
    use_pallas_sampler: bool = False
    # "exact": costs on the original pixel grid; "rect": costs on per-pair
    # epipolar-rectified grids where source sampling is row-aligned.
    cost_path: str = "exact"
    # Rect path: both bilinear taps of a source pixel as a bf16 pair in one
    # int32 word (ops/rowgather.pack_taps).
    pack_taps: bool = True
    # Rect path: ship image and gy tap words, derive gx in-kernel.
    grad_fwd_pack: bool = False
    # Rect path: ship only image tap words; source gradients come from
    # neighbouring window samples, Jacobian-corrected by the plane's
    # disparity slopes.  Takes precedence over grad_fwd_pack.
    window_grads: bool = True
    # With window_grads: one-sided differences at the window's outermost
    # rows/columns instead of an extra sampled ring.
    sdg_onesided_edges: bool = True
    # With window_grads: the whole window cost in one fused kernel
    # (ops/sdg_fused.py).
    fused_window_cost: bool = True
    # TPU kernel tuning (lane roll, row-block height); no effect here.
    fused_roll: bool = False
    fused_block_rows: int = 0
    # Skip fused-kernel work on [8, 128] rect tiles that hold no read-back
    # target; skipped outputs are unspecified and never read.
    rect_footprint_skip: bool = True
    # Extend that skip to the permute passes that touch non-target tiles.
    rect_permute_skip: bool = True
    # Two-stage cull: rank all K candidates with a sparse window (cull_box
    # at cull_increment spacing), evaluate the full window only for the
    # per-pixel sparse winner.
    rect_two_stage_cull: bool = False
    cull_box: int = 9
    cull_increment: int = 4
    # Screen on every cull_view_stride-th source view (1 = all views).
    cull_view_stride: int = 1
    # Pack the screening pass's permuted planes and costs at f16.
    cull_pack: bool = True
    # Screen on rect grids downscaled by this factor (1 = off).
    cull_downscale: int = 1
    # The current plane joins the screen; pixels it wins skip the full
    # pass (a dynamic fused-kernel tile mask).
    cull_early_term: bool = False
    cull_early_slack: float = 0.05
    # Rect-table slope target for contention-free 2-pass nearest routing;
    # the build supersamples rows/columns up to it.
    rect_slope_req: float = 1.0
    # Max fraction of pixels allowed inexact routing before the build
    # retries with larger scales, then drops the view.
    rect_routing_budget: float = 0.005
    # Disparity clamp margin (px) beyond the depth-range-induced interval.
    disp_clamp_margin: float = 8.0
    # Drop a source view whose pair cannot be rectified (it becomes an
    # invalid view) instead of failing the whole reference view over.
    rect_drop_unsupported_views: bool = True
    # "host": one dispatch per sub-sweep; "scan": a level as one program
    # (on the card one CUDA graph, models/patchmatch.run_iterations_scan).
    level_dispatch: str = "host"
    # All refinement rounds as one K-candidate batch around the sweep's
    # starting state (vs the reference's sequential rounds).
    refine_batched: bool = True
    # Coarse-to-fine pyramid (1 = off) and its fine-level schedule trims.
    pyramid_levels: int = 1
    pyramid_fine_iterations: int = 2
    pyramid_fine_far: bool = True
    pyramid_fine_refine_rounds: int = 0
    pyramid_carry_cost: bool = False
    # Cost-window size at downsampled pyramid levels (0 = box size).
    pyramid_coarse_box: int = 0
    # Cap on refinement_schedule length (first N rounds), 0 = full.
    refine_rounds_cap: int = 0
    # Forward permute of the planes m = n/d as 2 int32 words per candidate
    # (f16 pair + f32) instead of 3 f32 channels (ops/rect_cost._pack_m).
    rect_pack_m: bool = True
    # Round the rect scene's shapes up to buckets (the JAX package's compile
    # caching; the port builds the same shapes, models/rect_scene.py).
    rect_quantize_shapes: bool = False
    rect_quantum_rows: int = 64     # hrp rounding; multiple of 8
    rect_quantum_cols: int = 256    # wrp rounding; multiple of 128
    rect_quantum_range: float = 64.0  # disparity-range quantum (px)
    rect_pad_views_to: int = 0      # 0 = max_views

    @property
    def box_hrad(self) -> int:
        return (self.box_hsize - 1) // 2

    @property
    def box_vrad(self) -> int:
        return (self.box_vsize - 1) // 2

    def window_offsets(self) -> list[tuple[int, int]]:
        """Static list of sampled (dx, dy) window offsets.

        Mirrors the reference double loop ``for i in [-hrad, hrad] step
        WIN_INCREMENT`` (gipuma.cu:494-495,633-634).
        """
        xs = range(-self.box_hrad, self.box_hrad + 1, self.window_increment)
        ys = range(-self.box_vrad, self.box_vrad + 1, self.window_increment)
        return [(dx, dy) for dx in xs for dy in ys]

    def refinement_schedule(self) -> list[tuple[float, float]]:
        """(delta_z, delta_n) perturbation radii per refinement round.

        Mirrors ``for deltaZ = max_disp/2; deltaZ >= 0.01; deltaZ /= 10``
        with deltaN starting at 1.0 and dividing by 4 (gipuma.cu:945-993).
        The schedule length is static given the disparity range.
        """
        out = []
        delta_z = self.max_disparity / 2.0
        delta_n = self.refine_delta_n_init
        while delta_z >= self.refine_delta_z_floor:
            out.append((delta_z, delta_n))
            delta_z /= self.refine_delta_z_div
            delta_n /= self.refine_delta_n_div
        if self.refine_rounds_cap > 0:
            out = out[:self.refine_rounds_cap]
        return out

    def with_depth_range(self, depth_min: float, depth_max: float,
                         f: float, baseline: float) -> "AlgorithmParams":
        """Return params with depth range and the induced disparity range set.

        Mirrors main.cpp:898-912: min_disparity = f*b/depthMax,
        max_disparity = f*b/depthMin.  Values are rounded to 6 significant
        digits: params are JIT-static, and sub-ulp focal-length jitter
        between reference views must not trigger recompilation.
        """
        def sig6(v: float) -> float:
            return float(f"{v:.6g}")

        return dataclasses.replace(
            self,
            depth_min=sig6(depth_min),
            depth_max=sig6(depth_max),
            min_disparity=sig6(f * baseline / depth_max),
            max_disparity=sig6(f * baseline / depth_min),
        )

    def replace(self, **kw) -> "AlgorithmParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Dataset presets — mirrors scripts/*.sh parameter sets (SURVEY.md §2.6).
# ---------------------------------------------------------------------------

PRESETS: dict[str, AlgorithmParams] = {
    # scripts/dino.sh:8-24 (Middlebury dino/temple family)
    "middlebury": AlgorithmParams(
        box_hsize=11, box_vsize=11, iterations=8, n_best=2,
        depth_min=0.3, depth_max=0.8, view_selection=True,
        min_angle=5.0, max_angle=45.0,
    ),
    # scripts/dtu_fast.sh:10-21
    "dtu_fast": AlgorithmParams(
        box_hsize=15, box_vsize=15, iterations=6, n_best=3,
        depth_min=300.0, depth_max=800.0, view_selection=True,
        min_angle=10.0, max_angle=30.0, max_views=9,
    ),
    # scripts/dtu_accurate.sh:10-20
    "dtu_accurate": AlgorithmParams(
        box_hsize=25, box_vsize=25, iterations=8, n_best=3,
        depth_min=300.0, depth_max=800.0, view_selection=True,
        min_angle=10.0, max_angle=30.0, max_views=2**31 - 1,
    ),
    # High-resolution outdoor/indoor benchmarks (Tanks&Temples, ETH3D) —
    # a NEW workload class (the reference has no preset; BASELINE.json
    # config 5: "4K+ images, N-host distributed PatchMatch+fusion").
    # Depth range comes from SfM (bundler/colmap) per scene, so it is left
    # unset (-1 = infer); cam_scale 0.5 halves 4K-6K inputs toward the
    # rect path's table budget — pair with --distributed for multi-host
    # scans and fusion/sharded for the fused cloud.
    "highres": AlgorithmParams(
        box_hsize=15, box_vsize=15, iterations=6, n_best=3,
        depth_min=-1.0, depth_max=-1.0, view_selection=True,
        min_angle=5.0, max_angle=45.0, max_views=9, cam_scale=0.5,
        pyramid_levels=3, pyramid_fine_iterations=1,
    ),
}


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Consistency-fusion knobs; interface parity with out-of-tree fusibile
    (scripts/dtu_fast.sh:24-26, scripts/dino.sh:20-22)."""

    disp_thresh: float = 0.5
    normal_thresh: float = 30.0   # degrees
    num_consistent: int = 3
