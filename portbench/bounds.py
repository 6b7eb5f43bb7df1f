"""Bytes the program's kernels must move, per call, from the call's own
shapes (the sampler's bound, copied from chip_smoke.py, so the yardstick
stays fixed while the program changes).

Bytes count each input word read once and each output word written once;
a call's bound is its bytes at the HBM peak (``peaks.py``).
"""
from __future__ import annotations


def sampler_bytes(n_samples: int, C: int, H: int, W: int) -> int:
    """Bytes of one bilinear-sampler call: 8 B of coordinates in and 4C B
    out per sample, the [C, H, W] source once."""
    return n_samples * (8 + 4 * C) + 4 * C * H * W
