#!/usr/bin/env python3
"""Census depth accuracy of one package on a synthetic plane, on the CPU.

    python scripts/port_census_check.py {jax,torch} [--path rect|exact]
        [--h 60 --w 72 --focal 110 --cams 5 --texture sos|noise]
        [--iterations 3] [--preset middlebury]

Runs compute_depthmap with ``algorithm=CENSUS`` through the JAX package
(``jax``; its Pallas kernels in interpret mode, minutes to an hour) or the
PyTorch port (``torch``, ``device="cpu"``) on the same scene and prints
one JSON line with the median and 90th-percentile relative depth error on
the interior.  Without --preset the parameters are the /verify recipe's
(box 9, rect path with the two-stage cull on every second view); with it,
the preset's (chip_smoke.py's bench configuration).  Both packages seed
their own random draws, so the two runs agree in distribution, not bit
for bit.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=["jax", "torch"])
    ap.add_argument("--path", choices=["rect", "exact"], default="rect")
    ap.add_argument("--h", type=int, default=60)
    ap.add_argument("--w", type=int, default=72)
    ap.add_argument("--focal", type=float, default=110.0)
    ap.add_argument("--cams", type=int, default=5)
    ap.add_argument("--texture", default="sos")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--preset", default=None)
    a = ap.parse_args()
    if a.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from gipuma_tpu.config import PRESETS, AlgorithmParams
        from gipuma_tpu.config import MatchingAlgorithm
        from gipuma_tpu.pipeline import compute_depthmap
        from gipuma_tpu.utils.synthetic import make_ring_P, plane_scene
        kw = {}
    else:
        import torch
        torch.set_num_threads(2)
        from gipuma_tpu_torch.config import PRESETS, AlgorithmParams
        from gipuma_tpu_torch.config import MatchingAlgorithm
        from gipuma_tpu_torch.pipeline import compute_depthmap
        from gipuma_tpu_torch.utils.synthetic import make_ring_P, plane_scene
        kw = dict(device="cpu")
    images, _, gt, _ = plane_scene(num_cams=a.cams, h=a.h, w=a.w,
                                   focal=a.focal, plane_depth=5.0,
                                   slant=(0.2, -0.1), texture=a.texture)
    Ps = make_ring_P(a.cams, a.h, a.w, a.focal, target_depth=5.0)
    common = dict(depth_min=3.0, depth_max=8.0, min_angle=0.01,
                  max_angle=60.0, iterations=a.iterations,
                  algorithm=MatchingAlgorithm.CENSUS, cost_path=a.path)
    if a.preset:
        p = PRESETS[a.preset].replace(seed=0, pyramid_levels=1, **common)
    else:
        p = AlgorithmParams(box_hsize=9, box_vsize=9, **common)
    if a.path == "rect":
        p = p.replace(rect_two_stage_cull=True, cull_view_stride=2)
    t0 = time.perf_counter()
    res = compute_depthmap(images, Ps, p, **kw)
    m = 16 if a.preset else 10
    i = (slice(m, -m), slice(m, -m))
    err = np.abs(res.depth[i] - gt[i]) / gt[i]
    print(json.dumps({"package": a.package, "path": a.path,
                      "scene": [a.h, a.w, a.focal, a.cams, a.texture],
                      "iterations": a.iterations, "preset": a.preset,
                      "median_rel_err": float(np.median(err)),
                      "p90_rel_err": float(np.quantile(err, 0.9)),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
