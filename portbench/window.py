"""The measured window and its end-to-end statistics.

The window steps the program for ``seconds`` of the host's clock and ends
in a synchronize of the device. Its rate is every env transition completed
over the whole window; its step tail is the 95th percentile over every
step's period, a period being the time between the events recorded on the
stream after consecutive steps (the first from an event recorded before
the first step). The events are made and recorded once before the window,
so none is created inside it, and are read only after it.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np


@dataclass
class Window:
    steps: int                 # steps issued and completed
    wall_s: float              # host seconds, the final synchronize included
    periods_ms: List[float]    # one per step


def env_steps_per_s(w: Window, num_envs: int) -> float:
    """All env transitions of the window over all of its time."""
    return w.steps * num_envs / w.wall_s


def step_ms_p95(w: Window) -> float:
    """The 95th percentile of every step's period (numpy's linear rule)."""
    return float(np.percentile(np.asarray(w.periods_ms, np.float64), 95))


def quantiles(w: Window) -> list:
    """The periods' median, 95th and 99th percentiles and maximum."""
    return [float(x) for x in np.percentile(np.asarray(w.periods_ms, np.float64),
                                            [50, 95, 99, 100])]


def event_pool_size(steps_per_s: float, seconds: float) -> int:
    """Timing events to make before a window of ``seconds``: the steps the
    warm-up's rate ``steps_per_s`` would complete in it, and half as many
    again. A faster window records further events as it goes."""
    return int(math.ceil(1.5 * steps_per_s * seconds)) + 64


class CudaClock:
    """Step periods from CUDA events on the current stream."""

    def __init__(self, count: int):
        import torch

        self.torch = torch
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(count + 1)]
        for e in self.events:          # create each CUDA event now, not in the window
            e.record()
        torch.cuda.synchronize()

    def mark(self, i: int) -> None:
        """Record event ``i`` (0: before the first step; i: after step i)."""
        if i >= len(self.events):
            self.events.append(self.torch.cuda.Event(enable_timing=True))
        self.events[i].record()

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def periods_ms(self, steps: int) -> List[float]:
        ev = self.events
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]


class HostClock:
    """Step periods from the host's clock, for runs without a card (tests)."""

    def __init__(self, count: int = 0):
        self.t: list = []

    def mark(self, i: int) -> None:
        del self.t[i:]
        self.t.append(time.perf_counter())

    def sync(self) -> None:
        pass

    def periods_ms(self, steps: int) -> List[float]:
        return [1e3 * (b - a) for a, b in zip(self.t[:steps], self.t[1:steps + 1])]


def measure(step: Callable[[int], None], seconds: float, clock) -> Window:
    """Call ``step(k)`` for k = 0, 1, ... until ``seconds`` have passed on the
    host's clock, then synchronize: the window."""
    clock.sync()
    clock.mark(0)
    t0 = time.perf_counter()
    k = 0
    while True:
        step(k)
        k += 1
        clock.mark(k)
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    wall = time.perf_counter() - t0
    return Window(k, wall, clock.periods_ms(k))
