"""Throughput metering and torch.profiler traces.

Counterpart of marl_traffic_intersection_tpu/utils/profiling.py:
``StepsPerSecond`` meters the north-star metric (env-steps/s) and drops the
first, warm-up tick; ``trace_profile`` records a block with torch.profiler
(host and, where there is a card, device activity) and can write a Chrome
trace for chrome://tracing or Perfetto; ``profile_steps`` sums such a
record into the device's busy share and its top kernels.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepsPerSecond:
    """Steady-state steps/s meter; excludes the first (warm-up) tick."""

    def __init__(self, steps_per_tick: int = 1):
        self.steps_per_tick = steps_per_tick
        self._t0: Optional[float] = None
        self._ticks = 0
        self._warm = False

    def tick(self, n: Optional[int] = None):
        now = time.perf_counter()
        if not self._warm:  # drop the warm-up tick
            self._warm = True
            self._t0 = now
            self._ticks = 0
            return
        self._ticks += n if n is not None else self.steps_per_tick

    @property
    def value(self) -> float:
        if self._t0 is None or self._ticks == 0:
            return 0.0
        return self._ticks / (time.perf_counter() - self._t0)


@contextlib.contextmanager
def trace_profile(path: Optional[str] = None):
    """Profile a block with torch.profiler; yields the profiler and, when
    ``path`` is given, writes its Chrome trace there (.json, or .json.gz)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(str(path))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_steps(step_fn, steps: int, trace: Optional[str] = None) -> dict:
    """Device busy share and the top kernels of ``steps`` calls of
    ``step_fn``; the Chrome trace goes to ``trace`` when given."""
    _sync()
    with trace_profile(trace) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {
        "window_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [{"name": e.key[:80], "ms_per_step": dev_us(e) / steps / 1e3,
                         "launches_per_step": e.count / steps} for e in top],
    }
