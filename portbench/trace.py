"""What a traced run (``--trace 1``) reads from the device.

``profile_block`` runs a block of steps under torch.profiler (CUPTI) and
reduces its raw records: the device operations (kernels, copies, fills)
with their count and time, the seconds in which any of them ran (the union
of their intervals), and the block's wall time, which ends in a
synchronize. The profiler stretches the host's gaps between launches, so
the idle share it gives is an upper bound of the unprofiled run's. Each
idle gap of the device is put down to the innermost host operation running
at its middle. The arithmetic of the busy share and of the kernels by name
follows the port's ``utils/profiling.py::profile_steps`` (copied, not
imported: the benchmark reads only the program's counters and spans).

``lidar_ms`` times one call of the program's lidar op on given operands:
the call is captured once in a CUDA graph, ``calls`` times in a row, and
the graph replayed between two CUDA events, so the host's dispatch is out
and whatever implements the call is timed.
"""
from __future__ import annotations

import collections
import heapq
import time

import torch

TOP = 10


def _merged(intervals):
    """Sorted, overlapping intervals merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_block(step, steps: int) -> dict:
    """Profile ``step(k)`` for k below ``steps`` (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            step(k)
        sync()
        window_s = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), steps, window_s)


def reduce_events(events, steps: int, window_s: float) -> dict:
    """The profile's numbers from kineto's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        if e.is_async():
            continue
        span = (e.start_ns(), e.end_ns(), e.name())
        (dev if e.device_type() == cuda else host).append(span)
    by_name = collections.defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) / 1e9
    busy = _merged([(a, b) for a, b, _ in dev])
    gaps = collections.defaultdict(float)
    host.sort()
    active, i = [], 0       # heap of the host ops begun by ``mid``: (duration, end, name)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1] - host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        gaps[active[0][2] if active else "(no host op)"] += (start - end) / 1e9

    def top(d):
        return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"steps": steps, "window_s": window_s, "device_ops": len(dev),
            "device_s": sum(by_name.values()),
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "top_ops": top(by_name), "idle_gaps": top(gaps)}


def lidar_ms(lidar_scan, operands, calls: int = 20, replays: int = 5) -> float:
    """Device ms of one ``lidar_scan(*operands)`` (see the module docstring)."""
    here = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(here)
    with torch.cuda.stream(side):
        lidar_scan(*operands)           # the first call builds and caches
    here.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            lidar_scan(*operands)
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (calls * replays)
    del graph
    return ms
