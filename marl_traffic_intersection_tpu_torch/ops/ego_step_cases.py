"""Seeded inputs on which kernel K3 is held against its plain version.

``case_args(name, envs)`` returns the arguments of core/env.py::ego_step_ref
as CPU tensors (``on`` moves them to a device): the ego state, the actions,
dt, the step counter, the route table, the NPC slots (or None), the
configuration, the reward's parameters and the progress scale. chip_smoke.py
and the card tests feed them to the kernel, the CPU tests to the CPU build of
its pieces (csrc/ego_step_host.cpp).

A seeded batch mixes agents on their routes, at their goals, anywhere on or
off the screen, on the yellow lines, on another agent and on an NPC, some
dead, with zero and nonzero throttles and step counters at the truncation;
its NPC slots are tests/test_torch_npc.py's seeded pool. The ``edges`` case
adds the envs a batch rarely holds (EDGE_ENVS): ties in the path-index
window on a straight route appended to the table (and reached by route id
-1), a car exactly 40 px short of its goal, NaN and +-1e10 positions, a NaN
corner whose truncation lands on the line mask only where a NaN casts to 0,
+-0.0 headings, an env whose agents are all dead, and two boxes that touch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import PATH_LEN
from ..core.env import EgoState, EgoTables, EnvConfig, RewardParams
from ..core.routes import build_route_table, default_ego_routes
from .npc_move_cases import pool

DT = np.float32(1.0 / 60.0)
MAX_STEPS = 50


class NpcSlots(NamedTuple):
    """The NPC pool's fields the ego tick reads, (B, w)."""

    x: torch.Tensor
    y: torch.Tensor
    heading: torch.Tensor
    alive: torch.Tensor


# name: (agents, NPC slots, team reward, respawn, lanes)
CASES = {
    "n1": (1, 0, False, True, 3),
    "n2 team": (2, 0, True, True, 3),
    "n4": (4, 0, False, True, 3),
    "n4 team no-respawn": (4, 0, True, False, 3),
    "n4 two-lanes": (4, 0, False, True, 2),
    "n8": (8, 0, False, False, 3),
    "n1 w16 team": (1, 16, True, True, 3),
    "n2 w8 team no-respawn": (2, 8, True, False, 3),
    "n4 w32 no-respawn": (4, 32, False, False, 3),
    "n8 w8": (8, 8, False, True, 3),
    "n8 w16 team": (8, 16, True, True, 3),
    "n32 w8 team": (32, 8, True, True, 3),
    "edges": (4, 8, False, False, 3),
}
EDGE_ENVS = ("tie", "nan", "far", "nan on the line mask", "all dead", "touching")


@functools.lru_cache(maxsize=2)
def _table(lanes: int):
    return build_route_table(lanes)


def _tables(lanes: int, straight: bool) -> tuple:
    """The route table's arrays, with a straight route appended when
    ``straight``: y = 354 (a lane's centre), x = 40, 41, ..., its goal far
    ahead, its spawn heading -0.0."""
    t = _table(lanes)
    arrays = [t.paths, t.goal_xy, t.goal_prev_xy, t.spawn_xy, t.spawn_heading]
    if straight:
        line = np.stack([np.float32(40.0) + np.arange(PATH_LEN, dtype=np.float32),
                         np.full(PATH_LEN, 354.0, np.float32)], -1)
        extra = [line, [700.0, 354.0], [699.0, 354.0], [40.0, 354.0], -0.0]
        arrays = [np.concatenate([a, np.asarray(e, np.float32)[None]]) for a, e in
                  zip(arrays, extra)]
    return tuple(np.ascontiguousarray(a, np.float32) for a in arrays)


def _batch(rng, envs: int, n: int, w: int, lanes: int, tables: tuple) -> tuple:
    """A seeded batch as numpy arrays: (ego fields, actions, step counter,
    NPC slots or None)."""
    paths, goal, goal_prev = tables[:3]
    ids = _table(lanes).route_ids(default_ego_routes(4 * lanes * 3, lanes))
    f = np.float32
    shape = (envs, n)
    rid = ids[rng.randint(len(ids), size=shape)].astype(np.int32)
    k = rng.randint(0, PATH_LEN - 10, size=shape)
    here, ahead = paths[rid, k], paths[rid, k + 1]
    x = here[..., 0] + rng.normal(0, 2, shape)
    y = here[..., 1] + rng.normal(0, 2, shape)
    h = np.arctan2(-(ahead[..., 1] - here[..., 1]), ahead[..., 0] - here[..., 0])
    h = h + rng.normal(0, 0.05, shape)
    slots = None
    if w:
        st = pool(rng.randint(1 << 30), envs, w, p_alive=0.6, overlaps=2)
        slots = (st["x"], st["y"], st["heading"], st["alive"])
    kind = rng.choice(6, size=shape, p=[0.45, 0.15, 0.15, 0.05, 0.1, 0.1])
    at_goal = kind == 1
    x[at_goal] = goal[rid[at_goal], 0] + rng.normal(0, 6, at_goal.sum())
    y[at_goal] = goal[rid[at_goal], 1] + rng.normal(0, 6, at_goal.sum())
    anywhere = kind == 2
    x[anywhere] = rng.uniform(-150, 900, anywhere.sum())
    y[anywhere] = rng.uniform(-150, 900, anywhere.sum())
    line = kind == 3          # across a yellow line, outside the crossing
    x[line] = 375.0 + rng.uniform(-8, 8, line.sum())
    y[line] = rng.choice([100.0, 650.0], line.sum()) + rng.uniform(-30, 30, line.sum())
    h[line] = rng.choice([np.pi / 2, -np.pi / 2], line.sum())
    for b, i in zip(*np.nonzero(kind == 4)):          # on another agent or an NPC
        if slots is not None and rng.uniform() < 0.5:
            m = rng.randint(w)
            x[b, i], y[b, i] = slots[0][b, m], slots[1][b, m]
        else:
            j = rng.randint(n)
            x[b, i], y[b, i] = x[b, j], y[b, j]
        x[b, i] += rng.uniform(-30, 30)
        y[b, i] += rng.uniform(-15, 15)
    path_index = np.maximum(k - rng.randint(-2, 4, size=shape), 0)
    throttle = rng.uniform(-1, 1, shape)
    throttle[rng.uniform(size=shape) < 0.1] = 0.0
    ego = dict(route_id=rid, x=x, y=y, v=rng.uniform(0, 8, shape),
               heading=np.where(kind == 5, rng.uniform(-4, 4, shape), h),
               steering_angle=rng.uniform(-0.6, 0.6, shape), path_index=path_index,
               prev_dist_to_goal=np.where(rng.uniform(size=shape) < 0.3, 0.0,
                                          rng.uniform(0, 900, shape)),
               prev_acc_norm=rng.uniform(-1, 1, shape), prev_steer_norm=rng.uniform(-1, 1, shape),
               alive=rng.uniform(size=shape) < 0.85)
    ego = {key: a.astype(np.int32 if key in ("route_id", "path_index") else
                         bool if key == "alive" else f) for key, a in ego.items()}
    actions = np.stack([throttle, rng.uniform(-1, 1, shape)], -1).astype(f)
    step_count = rng.randint(0, MAX_STEPS, size=envs).astype(np.int32)
    step_count[rng.uniform(size=envs) < 0.2] = MAX_STEPS - 1
    return ego, actions, step_count, slots


def _edges(ego: dict, actions: np.ndarray, slots) -> None:
    """Write EDGE_ENVS into the first envs of a batch of 4 agents (in place)."""
    e = {name: i for i, name in enumerate(EDGE_ENVS)}
    f = np.float32
    k = len(EDGE_ENVS)
    for key in ("v", "steering_angle"):
        ego[key][:k] = 0.0
    actions[:k] = 0.0                      # no throttle, no steer: the poses stay
    ego["alive"][:k] = True
    # ties: half-way between points 60 and 61, and 140 and 141, of the
    # straight route (ids -1 and its own), headings +0.0 and -0.0; agents 2
    # and 3 dead, one -0.0
    b = e["tie"]
    ego["route_id"][b] = [-1, len(_table(3).paths), 0, 0]
    ego["x"][b, :2], ego["y"][b, :2] = [f(100.5), f(180.5)], f(354.0)
    ego["path_index"][b, :2] = [45, 130]
    ego["heading"][b] = [0.0, -0.0, -0.0, 0.0]
    ego["alive"][b, 2] = False
    # agent 3 exactly 40 px short of the goal (700, 354) along the route: not
    # a success, the test is strict
    ego["route_id"][b, 3], ego["x"][b, 3], ego["y"][b, 3] = -1, f(660.0), f(354.0)
    # NaN positions: the path index is the window's first point
    b = e["nan"]
    ego["x"][b, 0], ego["y"][b, 1] = np.nan, np.nan
    ego["x"][b, 2] = ego["y"][b, 2] = np.nan
    ego["heading"][b, 3] = np.nan
    # far off the screen
    b = e["far"]
    ego["x"][b] = [1e10, -1e10, 375.0, 1e10]
    ego["y"][b] = [375.0, 375.0, -1e10, 1e10]
    # a NaN x with a corner's y on the horizontal line band: on the card the
    # truncated NaN is 0, a line pixel; on the CPU it is INT32_MIN, off the
    # mask
    b = e["nan on the line mask"]
    ego["x"][b, 0], ego["y"][b, 0], ego["heading"][b, 0] = np.nan, 385.0, 0.0
    ego["alive"][b, 1:] = False           # a NaN box overlaps every other
    # every agent dead
    ego["alive"][e["all dead"]] = False
    # two boxes that touch, one car length apart: they overlap (the test's
    # comparisons are strict); a third car alone, a fourth dead
    b = e["touching"]
    ego["route_id"][b] = -1
    ego["x"][b], ego["y"][b], ego["heading"][b] = [300.0, 354.0, 600.0, 500.0], 354.0, 0.0
    ego["alive"][b, 3] = False
    if slots is not None:
        slots[3][:k] = False


def case_args(name: str, envs: int = 64, seed: int = 0) -> tuple:
    """One of CASES on ``envs`` envs (at least len(EDGE_ENVS) for ``edges``), seeded by
    the case's name and ``seed``."""
    n, w, team, respawn, lanes = CASES[name]
    edges = name == "edges"
    tables = _tables(lanes, straight=edges)
    rng = np.random.RandomState((sum(map(ord, name)) * 7919 + seed) % (1 << 31))
    ego, actions, step_count, slots = _batch(rng, envs, n, w, lanes, tables)
    if edges:
        _edges(ego, actions, slots)
    cfg = EnvConfig(num_agents=n, num_lanes=lanes, traffic_flow=w > 0, max_npcs=max(w, 1),
                    use_team_reward=team, respawn_enabled=respawn, max_steps=MAX_STEPS)
    t = torch.from_numpy
    max_progress = float(np.float32(np.hypot(np.float32(750), np.float32(750))))
    return (EgoState(**{k: t(np.ascontiguousarray(a)) for k, a in ego.items()}), t(actions),
            torch.tensor(DT), t(step_count), EgoTables(*map(t, tables)),
            None if slots is None else NpcSlots(*(t(np.ascontiguousarray(a)) for a in slots)),
            cfg, RewardParams(), max_progress)


def nan_as_one(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every NaN made the one NaN: a NaN's sign and payload follow
    the library that made it (torch's CPU fmod gives 0x7fffffff where C's
    fmodf keeps its operand's 0x7fc00000); every other bit must agree."""
    return torch.where(t.isnan(), torch.nan, t) if t.is_floating_point() else t


def tick_bits(tick) -> list:
    """An ``EgoTick``'s tensors on the host, the ego's then the results, each
    NaN made the one NaN and floats viewed as int32, to compare bit for bit."""
    out = []
    for t in list(tick.ego) + list(tick[1:]):
        t = nan_as_one(t.cpu())
        out.append(t.view(torch.int32) if t.is_floating_point() else t)
    return out


def on(args: tuple, device) -> tuple:
    """``args`` with every tensor moved to ``device``, made contiguous."""
    def move(a):
        if torch.is_tensor(a):
            return a.to(device).contiguous()
        if isinstance(a, tuple) and hasattr(a, "_fields") and not isinstance(a, RewardParams):
            return type(a)(*map(move, a))
        return a
    return tuple(move(a) for a in args)
