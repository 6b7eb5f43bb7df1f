"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload dino.exact --seed 7 --seconds 45 --trace 0

From the root of a checkout, on a machine with a CUDA card.  The last line
of standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit); the last lines of
standard error repeat the checks.  Without a card, with a cell whose
files are missing, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel and extension caches at fixed paths inside the checkout, so a
# cell's second run there finds everything built.
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def driver(cell):
    """The module whose run_cell runs the cell: ``portbench.core`` unless
    the cell's mix names a driver (``"driver": "folder"`` ->
    ``portbench/folder.py``)."""
    from portbench import core
    name = cell.mix.get("driver")
    if name is None:
        return core
    if not (isinstance(name, str) and name.isidentifier()
            and (ROOT / "portbench" / f"{name}.py").is_file()):
        raise core.ConfigError(f"the mix names no driver file: {name!r}")
    return importlib.import_module(f"portbench.{name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def err(*a):
        print(*a, file=sys.stderr, flush=True)

    from portbench import core
    try:
        cell = core.load_cell(args.workload)
    except core.ConfigError as e:
        err(f"portbench: {e}")
        return 2
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"portbench: the cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        result = driver(cell).run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START,
                                       log=err)
    except core.ConfigError as e:
        err(f"portbench: {e}")
        return 2
    bad = core.forbidden_modules(sys.modules)
    if bad:
        err("portbench: forbidden modules loaded: " + ", ".join(bad))
        return 4
    for name, row in result["checks"].items():
        err(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
