"""Profiling / observability helpers.

Counterpart of ``gipuma_tpu/utils/profiling.py:1-53``.  The reference's
instrumentation is cudaEvent timing around the kernel loop plus
runtime-per-pixel printouts (gipuma.cu:1836-1952, main.cpp:1071-1084).
Here: wall-clock phase timers that wait for the device, a
megapixel-depthmaps/s meter, and torch.profiler trace capture.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def _sync(obj) -> None:
    """Wait for the CUDA devices of every tensor in `obj` (a tensor or a
    nested list / tuple / dict of them); the PhaseTimer's counterpart of
    jax.block_until_ready."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _sync(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _sync(v)


@dataclass
class PhaseTimer:
    """Accumulates per-phase wall-clock (device-synced) durations."""

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>20}: {v:8.3f} s ({100*v/max(total,1e-12):5.1f}%)"
                 for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1])]
        lines.append(f"{'total':>20}: {total:8.3f} s")
        return "\n".join(lines)


def megapixels_per_second(num_pixels: int, seconds: float) -> float:
    return num_pixels / 1e6 / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the host and, where CUDA is available, the
    device, written to `log_dir` for TensorBoard (the JAX package's
    jax.profiler trace)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
