"""gipuma_tpu_torch — the PyTorch / CUDA port of gipuma_tpu.

A second package beside the JAX one: same module paths and public names,
torch tensors on an explicit device, and every TPU kernel of the ported
path rewritten by hand in CUDA C++ for Hopper (``csrc/``).  It imports
nothing of JAX and nothing of ``gipuma_tpu``.

``pipeline.compute_depthmap`` runs the engine in ``models.patchmatch`` on
the exact cost path (``ops.cost``, whose kernel is the bilinear sampler
``ops.sampling``) or on the rectified path (``models.rect_scene`` and
``ops.rect_cost``, whose kernels are the row gathers of ``ops.rowgather``
— nearest, lerp and affine — and the fused window cost ``ops.sdg_fused``),
at one resolution or as a coarse-to-fine pyramid (``models.pyramid``).
"""
from __future__ import annotations

import importlib
import pkgutil
import sys

from .config import PRESETS, AlgorithmParams, CostCombination, MatchingAlgorithm

__all__ = ["AlgorithmParams", "PRESETS", "CostCombination",
           "MatchingAlgorithm", "import_all", "foreign_modules"]


def import_all() -> list[str]:
    """Import every module of the package; returns their names."""
    names = []
    for mod in pkgutil.walk_packages(__path__, prefix=__name__ + "."):
        importlib.import_module(mod.name)
        names.append(mod.name)
    return names


def foreign_modules() -> list[str]:
    """After import_all(): the loaded modules of JAX or of the JAX package
    (empty when the port stands alone)."""
    import_all()
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "gipuma_tpu"))
