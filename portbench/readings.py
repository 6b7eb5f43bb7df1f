"""Readings for a cell's correctness limits: the program's numbers and the
control's, seed by seed, in one process.

    python3 portbench/readings.py --workload dino.exact --seeds 11,12,13 [--views 8]

For each seed it builds the cell's scene, runs the program over the first
``--views`` reference views of the window's order (default: the check's
sample size) and judges them as a run's check does; then it puts the
control in the program's place on the same views (``check.control_outputs``)
and judges that.  One JSON line per seed, then a summary line: per number
the largest program reading (the lower reading) and the smallest control
reading (the upper one).  It needs a card, as a run does.

A cell whose mix names the folder driver takes one whole run a seed
(``folder.reading``: every view of a scan, at the cell's own size and
ranks) and the control on the same seed (``folder_check.control_numbers``);
``--views`` does not apply there.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seeds, views: int | None, device, log=print) -> dict:
    import numpy as np
    import torch
    from gipuma_tpu_torch import pipeline
    from portbench import check, core, scene as scene_mod

    if cell.mix.get("driver") == "folder":
        from portbench import folder
        return summarise(cell, [folder.reading(cell, s, device, log)
                                for s in seeds], None, log)
    params = core.program_params(cell.config, cell.mix)
    views = views or cell.config["check"]["views"]
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        scene = scene_mod.make_scene(cell.config, seed, device)
        order = cell.config["window_views"]
        start = int(np.random.default_rng([seed, 1]).integers(len(order)))
        refs = [order[(start + k) % len(order)] for k in range(views)]
        outs = [core.run_view(pipeline, scene, params, r, device, None).out
                for r in refs]
        t1 = time.perf_counter()
        prog = check.judge(scene, outs, cell.config, seed, device)
        c_outs, cost_of = check.control_outputs(scene, refs, cell.config,
                                                device)
        ctl = check.judge(scene, c_outs, cell.config, seed, device,
                          cost_of=cost_of)
        line = {"seed": seed, "refs": refs, "program": prog, "control": ctl,
                "run_s": t1 - t0, "judge_s": time.perf_counter() - t1}
        lines.append(line)
        log(json.dumps(line))
        del outs, c_outs, scene
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return summarise(cell, lines, views, log)


def summarise(cell, lines: list, views, log) -> dict:
    """Per number, the program's largest reading and the control's
    smallest."""
    names = lines[0]["program"].keys()
    summary = {k: {"lower": max(x["program"][k] for x in lines),
                   "upper": min(x["control"][k] for x in lines)}
               for k in names}
    log(json.dumps({"workload": cell.workload["name"], "seeds": len(lines),
                    "views": views, "summary": summary}))
    return {"lines": lines, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--views", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import core
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    cell = core.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    readings(cell, seeds, args.views, "cuda",
             log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
