"""Small cells for the benchmark's CPU tests: the committed cells with
fewer envs, a short warm-up and every env row checked."""
from __future__ import annotations

import torch

from portbench import spec

torch.set_num_threads(2)

CELLS = ("cfg5-rollout-4096x4", "cfg4-traffic-d1-4096x8")


def tiny(name: str, envs: int = 8, warmup: int = 5, check_steps: int = 2,
         horizon: int = 3, check_envs: int = None, max_steps: int = None) -> spec.Cell:
    """``name`` at ``envs`` envs, its check drawing ``check_envs`` rows
    (default: every row) and the 2 envs nearest their episode's end;
    ``max_steps`` shortens the episodes (with the staggered phases and
    ``max_steps`` <= ``envs`` some env auto-resets in every step)."""
    cell = spec.load(name)
    cell.config = dict(cell.config, num_envs=envs)
    if max_steps is not None:
        cell.config["max_steps"] = max_steps
    cell.traffic = dict(cell.traffic, warmup_steps=warmup, profile_steps=2,
                        check=dict(steps=check_steps, horizon=horizon,
                                   envs=envs if check_envs is None else check_envs, ending=2))
    return cell
