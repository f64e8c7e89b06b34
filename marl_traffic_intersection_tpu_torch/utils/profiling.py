"""Throughput metering and torch.profiler traces.

Counterpart of marl_traffic_intersection_tpu/utils/profiling.py:
``StepsPerSecond`` meters the north-star metric (env-steps/s) and drops the
first, warm-up tick; ``trace_profile`` records a block with torch.profiler
(host and, where there is a card, device activity) and can write a Chrome
trace for chrome://tracing or Perfetto; ``profile_steps`` sums such a
record into the device's busy share and its top kernels;
``collective_census`` lists the torch.distributed collectives a block
issues.
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


def records(prof, device_type=torch.autograd.DeviceType.CUDA) -> dict:
    """{name: [count, total µs]} of ``prof``'s records on ``device_type``,
    read from the profiler's raw records. ``prof.key_averages()`` gives the
    same counts and device times, but first builds every host op's call tree:
    tens of seconds for a training update's ~10^5 launches."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device_type and not e.is_async():
            rec = out.setdefault(e.name(), [0, 0.0])
            rec[0] += 1
            rec[1] += (e.end_ns() - e.start_ns()) / 1e3
    return out


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
    kernels = records(prof)
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    return {
        "window_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches_per_step": sum(n for n, _ in kernels.values()) / steps,
        "top_kernels": [{"name": name[:80], "ms_per_step": us / steps / 1e3,
                         "launches_per_step": n / steps} for name, (n, us) in top],
    }


COLLECTIVES = ("all_reduce", "all_gather", "broadcast")   # all that the port calls


def _elements(out) -> int:
    """The elements a collective's call delivers to this rank, from its first
    argument: the whole of an all-reduce's or a broadcast's tensor, every
    part of a gather's output list."""
    if isinstance(out, (list, tuple)):
        return sum(t.numel() for t in out)
    return out.numel()


@contextlib.contextmanager
def collective_census():
    """Count the torch.distributed collectives issued inside the block:
    yields a list that gains ``(name, elements, ranks)`` per call (the
    elements delivered to this rank, the size of the call's group). It
    wraps the attributes of ``torch.distributed``, so it sees a call only
    where the call site looks the function up as ``dist.<name>`` when it
    runs; every call site of the port does, and
    tests/test_torch_scaling.py holds the port's sources to that."""
    import torch.distributed as dist

    calls = []
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name, fn):
        def call(*args, **kw):
            calls.append((name, _elements(args[0]), dist.get_world_size(kw.get("group"))))
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
