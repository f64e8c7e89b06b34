"""Batched environment with auto-reset.

Counterpart of marl_traffic_intersection_tpu/envs/vector.py. The port's env
already steps a batch, so ``VectorEnv`` adds what the batch needs on top:
route sampling at (auto-)reset, the obs-once auto-reset merge (a fresh env
starts with an empty NPC pool), and ``final_obs``.

Random draws come from injectable sources. Routes: by default a
``torch.Generator`` on the env's device (each env draws its agents' routes
from the pool without replacement), or any callable
``route_sampler(num_envs) -> (num_envs, N)`` route-id tensor, which is how
tests replay the JAX package's draws (torch cannot reproduce jax.random
streams). NPC spawns likewise: ``core.npc.spawn_decision`` on the same
generator by default, or ``spawn_sampler(num_envs) -> (do_try,
route_choice)``, each (num_envs,). The NPC pool runs at its full width (the
JAX package's slot-prefix tiering is not ported).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.constants import DT_DEFAULT
from ..core.env import EnvState, IntersectionEnv
from ..core.npc import spawn_decision
from ..core.routes import default_ego_routes


class VectorEnv:
    """``num_envs`` auto-reset envs of ``env``'s configuration on its device."""

    def __init__(self, env: IntersectionEnv, num_envs: int,
                 route_pool: Optional[np.ndarray] = None, auto_reset: bool = True,
                 seed: int = 0,
                 route_sampler: Optional[Callable[[int], torch.Tensor]] = None,
                 spawn_sampler: Optional[Callable[[int], Tuple[torch.Tensor,
                                                               torch.Tensor]]] = None):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        if route_pool is None:
            pool = env.table.route_ids(default_ego_routes(
                max(env.config.num_agents, 12), env.config.num_lanes))
            route_pool = np.unique(pool)
        self.route_pool = torch.as_tensor(np.asarray(route_pool, np.int32),
                                          device=env.device)
        self.generator = torch.Generator(device=env.device).manual_seed(seed)
        self.route_sampler = route_sampler or self.sample_routes
        self.spawn_sampler = spawn_sampler

    def sample_routes(self, num_envs: int) -> torch.Tensor:
        """(num_envs, N) route ids from the pool: without replacement when the
        pool is large enough (duplicate routes share a spawn point, and such
        agents crash into each other at spawn forever), else with."""
        n = self.env.config.num_agents
        p = self.route_pool.shape[0]
        dev = self.env.device
        if p < n:
            idx = torch.randint(p, (num_envs, n), generator=self.generator, device=dev)
        else:
            u = torch.rand((num_envs, p), generator=self.generator, device=dev)
            idx = torch.argsort(u, dim=-1)[:, :n]
        return self.route_pool[idx]

    def reset(self):
        """Batched reset: (state, obs) with leading dim num_envs."""
        state = self.env.reset_state(self.route_sampler(self.num_envs))
        return state, self.env.observe(state)

    def step(self, state: EnvState, actions: torch.Tensor, dt: float = DT_DEFAULT,
             final_obs: bool = False):
        """Batched step; actions (B, N, 2). Envs whose episode ended start a
        fresh one, and the returned obs is the fresh one's.

        The obs is built once, on the merged state. ``final_obs=True`` also
        returns the terminal observation of the stepped (pre-reset) state.
        """
        cfg, spawn = self.env.config, None
        if cfg.traffic_flow:
            spawn = self.spawn_sampler(self.num_envs) if self.spawn_sampler else \
                spawn_decision(self.generator, self.num_envs, self.env.traffic_ids.shape[0],
                               cfg.traffic_density, dt)
        if not self.auto_reset:
            return self.env.step(state, actions, dt, spawn=spawn)
        new_state, out = self.env.step(state, actions, dt, with_obs=False, spawn=spawn)
        ep_done = out.terminated | out.truncated                     # (B,)
        fresh = self.env.reset_state(self.route_sampler(self.num_envs))

        def pick(a, b):
            return torch.where(ep_done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        npc = new_state.npc
        if cfg.traffic_flow:
            npc = type(npc)(*(pick(a, b) for a, b in zip(fresh.npc, npc)))
        merged = EnvState(
            ego=type(new_state.ego)(*(pick(a, b) for a, b in zip(fresh.ego, new_state.ego))),
            lidar=pick(fresh.lidar, new_state.lidar),
            step_count=pick(fresh.step_count, new_state.step_count), npc=npc)
        out = out._replace(obs=self.env.observe(merged))
        if final_obs:
            return merged, out, self.env.observe(new_state)
        return merged, out

