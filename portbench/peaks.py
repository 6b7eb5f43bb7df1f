"""The yardstick's constants: the card's published peaks and the names of
the program's own CUDA kernels as the profiler shows them.

Peaks are NVIDIA's data-sheet figures for one H100 SXM5 (dense, at the
700 W power limit): HBM3 bandwidth and FP32 outside the tensor cores.
A card whose name is not listed has no peaks here, and the rooflines
read nothing on it.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}

# The program's kernels -> the prefix of their __global__ functions'
# names (csrc/*.cu); every other device operation is glue.
PORT_KERNEL_SYMBOLS = {
    "row_gather_nearest": "row_gather_nearest_kernel",
    "sdg_fused_cost": "sdg_fused_",
    "bilinear_sample": "bilinear_sample_kernel",
    "row_gather_lerp": "row_gather_lerp_kernel",
    "row_gather_affine": "row_gather_affine_kernel",
    "permute2d": "permute2d_kernel",
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def is_port_kernel(name: str) -> bool:
    return any(sym in name for sym in PORT_KERNEL_SYMBOLS.values())
