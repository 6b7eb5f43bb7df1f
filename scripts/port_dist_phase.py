#!/usr/bin/env python3
"""chip_smoke.py's phase (i) alone: the parallel layer on the cards found.

    python3 scripts/port_dist_phase.py     # from the repository root

Builds the kernels, then runs phase (i)'s sub-runs through chip_smoke.py's
own functions, each held to the same checks: (i1) view-sharded rect on 3
ranks and (i3) tile x view rect 2 x 2 on the 640x480 bench scene, then
the 16-view batch folder with batch run (a) (scripts/dino.sh's flags
through the CLI in one process: the reference of (i5)) and, in one
2-rank world, (i2) view-sharded exact, (i4) tiled exact (propagation
only) and (i5) the CLI's --distributed with the sharded fusion.  With a
card per rank the ranks use NCCL, with fewer cards gloo
(chip_smoke.dist_backend).  Prints the card line, one `dist` JSON line
per sub-run and the seconds it took; exits non-zero when a check fails
or no card is present.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a card",
                2)
    from gipuma_tpu_torch import kernels
    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"card: {card}; cards visible: {torch.cuda.device_count()}; "
           f"torch {torch.__version__}")
    kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    device = torch.device("cuda")
    images, rig, gt, Ps, paths = cs.scene_setup()
    bench = cs.DistBench(torch, np, device, images, rig, gt, Ps,
                         paths["exact"])
    lines = cs.dist_bench_phase(torch, card, bench)
    with tempfile.TemporaryDirectory() as td:
        folder = cs.batch_folder(np, td)
        cs.batch_cli_run(torch, np, device, card, folder, "a")
        torch.cuda.empty_cache()
        lines.update(cs.dist_pair_phase(torch, np, card, bench, folder))
    cs.log(f"phase (i) sub-runs {sorted(lines)} passed in "
           f"{time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
