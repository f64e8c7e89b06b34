"""The benchmark's one traffic generator: every input of a run, drawn from
``--seed`` by the parameters of a traffic file (portbench/traffic/*.json).

A run's inputs are drawn on the device in a few large calls before the
window, into banks that the window cycles through:

  * actions (where ``banks`` has ``actions``): each component a standard
    normal, as an untrained PPO policy samples them (its log-std starts at
    0); a mix whose actions a policy computes has no action bank;
  * routes: each env's N agents drawn from the route pool without
    replacement, for the reset and for every auto-reset;
  * NPC spawns (``density`` not null): the reference's law
    (TrafficFlow.cpp:275-328, the port's ``core/npc.py::spawn_decision``):
    per env and step a try where a uniform lies below
    p = 1 - exp(-density * dt), float32, on a uniform traffic route;
  * the episodes' phases (``stagger_episodes``): the env's step counters
    start at 0, 1, ..., ``max_steps`` - 1, 0, 1, ... in an order drawn
    from the seed, so that in every step of a run the same number of
    episodes (B / ``max_steps``, rounded down or up) reach ``max_steps``
    and auto-reset, as in a long rollout.

A crowded env (``crowd`` not null): for two warm-up steps env 0's NPC pool
holds ``crowd`` NPCs at one spawn point, overlapping; then the real state
comes back. A crowded env makes the program widen its NPC pool and run its
NPC loops at that width, so that the set-up, and not the window, captures
what a rare crowded env of the window would need.

The banks have prime lengths, so the combination of a step's actions,
routes and spawns repeats only after their product. Step ``k`` of a run
(the reset is call 0 of the route draws) takes entry ``k % len`` of each.
Which env rows and which window steps the check compares is drawn from the
seed too (``check``: ``envs`` rows, ``steps`` steps below ``horizon``; the
check adds at each checked step the ``ending`` envs nearest the end of
their episode, which auto-reset in it, and the ``busiest`` envs,
check.py). The same seed gives the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

DT = 1.0 / 60.0       # the reference's fixed step (cpp/constants.h:9)
_KEYS = {"entry", "density", "warmup_steps", "crowd", "banks", "stagger_episodes", "check",
         "profile_steps", "why"}


def seed64(seed: int) -> int:
    """``--seed`` as a generator seed: any whole number, taken modulo 2**64."""
    return int(seed) % (1 << 64)


def validate(traffic: dict) -> dict:
    """``traffic`` (a traffic file's object) with its keys checked."""
    unknown = set(traffic) - _KEYS
    missing = _KEYS - {"entry", "why"} - set(traffic)
    if unknown or missing:
        raise ValueError(f"traffic file: unknown keys {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    return traffic


class Sampler:
    """A draw of the env's (``route_sampler``, ``spawn_sampler``): call ``i``
    returns entry ``i % len(bank)``; ``last`` is the entry the latest call
    returned."""

    def __init__(self, bank):
        self.bank = bank
        self.size = (bank[0] if isinstance(bank, tuple) else bank).shape[0]
        self.calls = 0
        self.last = None

    def entry(self, i: int):
        j = i % self.size
        if isinstance(self.bank, tuple):
            return tuple(b[j] for b in self.bank)
        return self.bank[j]

    def __call__(self, num_envs: int):
        self.last = self.calls % self.size
        self.calls += 1
        out = self.entry(self.last)
        rows = (out[0] if isinstance(out, tuple) else out).shape[0]
        if rows != num_envs:
            raise ValueError(f"the bank holds {rows} envs, the env asks for {num_envs}")
        return out


@dataclass
class Inputs:
    """Everything a run feeds the program, drawn from one seed."""

    actions: Optional[torch.Tensor]  # (Ka, B, N, 2) float32, or None (no action bank)
    routes: Sampler                  # over (Kr, B, N) int32
    spawns: Optional[Sampler]        # over ((Ks, B) bool, (Ks, B) int32), or None
    step_count: Optional[torch.Tensor]   # (B,) int32 episode phases, or None
    check_rows: np.ndarray           # env rows the check compares, sorted
    check_steps: list                # window steps the check compares, sorted


def make_inputs(traffic: dict, num_envs: int, num_agents: int, max_steps: int,
                route_pool: np.ndarray, num_traffic_routes: int, seed: int,
                device) -> Inputs:
    """Draw a run's inputs (see the module docstring) on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed64(seed))
    banks = traffic["banks"]
    B, N = num_envs, num_agents
    actions = torch.randn((banks["actions"], B, N, 2), generator=g, device=dev) \
        if "actions" in banks else None
    pool = torch.as_tensor(route_pool, dtype=torch.int32, device=dev)
    if pool.shape[0] < N:
        raise ValueError(f"{pool.shape[0]} routes in the pool for {N} agents")
    u = torch.rand((banks["routes"], B, pool.shape[0]), generator=g, device=dev)
    routes = pool[torch.argsort(u, dim=-1)[..., :N]]
    del u
    spawns = None
    if traffic["density"] is not None:
        p_try = float(np.float32(1.0) - np.exp(-np.float32(traffic["density"])
                                               * np.float32(DT)))
        Ks = banks["spawns"]
        do_try = torch.rand((Ks, B), generator=g, device=dev) < p_try
        choice = torch.randint(max(num_traffic_routes, 1), (Ks, B), generator=g, device=dev,
                               dtype=torch.int32)
        spawns = Sampler((do_try, choice))
    step_count = None
    if traffic["stagger_episodes"]:
        order = torch.argsort(torch.rand((B,), generator=g, device=dev))
        step_count = (order % max_steps).to(torch.int32)
    rng = np.random.default_rng(seed64(seed))
    check = traffic["check"]
    rows = np.sort(rng.choice(B, size=min(check["envs"], B), replace=False))
    steps = sorted(int(s) for s in rng.choice(check["horizon"], size=check["steps"],
                                              replace=False))
    return Inputs(actions, Sampler(routes), spawns, step_count, rows, steps)


def crowded(state, n: int, ref):
    """``state`` with env 0's NPC pool holding ``n`` NPCs, uids 0 to n - 1,
    at rest at the spawn point of the first traffic route of ``ref`` (the
    reference env, whose tables the benchmark built)."""
    r = int(ref.traffic_ids[0])
    sx, sy = (float(v) for v in ref.table.spawn_xy[r])
    pool = {name: t.clone() for name, t in state.npc._asdict().items()}
    put = {"alive": True, "x": sx, "y": sy, "v": 0.0,
           "heading": float(ref.table.spawn_heading[r]), "steering_angle": 0.0,
           "route_id": r, "path_index": 0}
    for name, value in put.items():
        pool[name][0, :n] = value
    pool["uid"][0, :n] = torch.arange(n, dtype=pool["uid"].dtype)
    pool["next_uid"][0] = n
    return state._replace(npc=type(state.npc)(**pool))

