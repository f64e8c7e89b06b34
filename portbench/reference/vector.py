"""The batched step with auto-reset, and the route pool it draws from.

An env whose episode ended (terminated or truncated) starts a fresh one on
the routes drawn for it: its egos respawn, its lidar reads the maximum and
its NPC pool empties. The observation is built once, on the merged state.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import DT_DEFAULT
from .env import EnvState, IntersectionEnv
from .routes import default_ego_routes


def route_pool(env: IntersectionEnv) -> np.ndarray:
    """The route ids an auto-reset draws from: the default ego routes of
    max(N, 12) agents, each once."""
    cfg = env.config
    ids = env.table.route_ids(default_ego_routes(max(cfg.num_agents, 12), cfg.num_lanes))
    return np.unique(ids).astype(np.int32)


def step(env: IntersectionEnv, state: EnvState, actions: torch.Tensor, spawn, routes,
         dt: float = DT_DEFAULT):
    """One auto-reset step: ``(merged state, out)``; ``routes`` (B, N) are the
    fresh episodes' routes, ``spawn`` the tick's NPC spawn draw (or None)."""
    new_state, out = env.step(state, actions, dt, with_obs=False, spawn=spawn)
    ep_done = out.terminated | out.truncated
    fresh = env.reset_state(routes)

    def pick(a, b):
        return torch.where(ep_done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    npc = new_state.npc
    if env.config.traffic_flow:
        npc = type(npc)(*(pick(a, b) for a, b in zip(fresh.npc, npc)))
    merged = EnvState(
        ego=type(new_state.ego)(*(pick(a, b) for a, b in zip(fresh.ego, new_state.ego))),
        lidar=pick(fresh.lidar, new_state.lidar),
        step_count=pick(fresh.step_count, new_state.step_count), npc=npc)
    return merged, out._replace(obs=env.observe(merged))
