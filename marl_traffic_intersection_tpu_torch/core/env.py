"""Intersection environment over an explicit batch of envs.

Counterpart of marl_traffic_intersection_tpu/core/env.py (reference:
cpp/IntersectionEnv.cpp:133-520). Where the JAX package vmaps a single-env
step, every tensor here carries a leading env axis B and an agent axis N.
``EnvState`` is a value of tensors; ``step`` returns a new one and never
writes the one it was given.

Per tick, in the reference's order:
  1. NPC traffic: spawn, controllers, collisions, despawn (core/npc.py)
                                                        [traffic_flow]
  2. ego physics, path index, progress/stuck/smooth base reward
  3. per-ego status: SUCCESS -> out of screen -> off road -> line crossing
  4. ordered ego-ego SAT collisions, and ego-NPC overlaps -> CRASH_CAR
  5. terminal bonuses, team reward mixing
  6. respawn (crashes only) or terminated-on-any-done
  7. terminated when all alive agents succeeded; truncation at max_steps
     (2-7: ``ego_step_ref``; on the card one launch of kernel K3)
  8. lidar on the post-respawn state against the egos and the alive NPCs
     (kernel K1), observation (B, N, 127)

The float chain is the reference's, which in the JAX package is the chain of
``exact_obs=True`` with ``exact_trig=True``: glibc trig, atan2f and hypotf
(ops/libm.py), IEEE divisions, correctly rounded square roots, every
product rounded before its add, the team average summed in agent order, and
the respawn heading fetched with its sign bit.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import libm
from ..ops.ego_step_cuda import ego_step as ego_step_cuda
from ..ops.lidar_cuda import lidar_scan
from ..utils.graphs import EAGER
from .constants import (DT_DEFAULT, FPS, HEIGHT, LIDAR_MAX_DIST, LIDAR_RAYS,
                        MAX_ACC, MAX_STEERING_ANGLE, NEIGHBOR_COUNT, OBS_DIM,
                        PATH_LEN, PHYSICS_MAX_SPEED, PI_F, SCALE, STATUS_ALIVE,
                        STATUS_CRASH_CAR, STATUS_CRASH_LINE, STATUS_CRASH_WALL,
                        STATUS_DEAD, STATUS_SUCCESS, WIDTH)
from .geometry import hits_yellow_line, is_line_pixel, is_on_road
from .npc import (NpcState, exact_begin, exact_end, exact_segments, init_npc_state,
                  npc_traffic_update_fast, npc_traffic_update_serial)
from .physics import (car_corners, car_physics_step, sat_overlap,
                      update_path_index, wrap_angle)
from .routes import RouteTable, build_route_table, default_ego_routes

_F = torch.float32
_I = torch.int32
_PI32 = float(np.float32(PI_F))


class RewardParams(NamedTuple):
    """Reward knobs (reference: cpp/Reward.h:5-14 defaults), f32 values."""

    k_prog: float = float(np.float32(10.0))
    v_min_ms: float = float(np.float32(1.0))
    k_stuck: float = float(np.float32(-0.01))
    k_cv: float = float(np.float32(-10.0))
    k_co: float = float(np.float32(-5.0))
    k_succ: float = float(np.float32(10.0))
    k_sm: float = float(np.float32(-0.02))
    alpha: float = float(np.float32(0.2))


@dataclass(frozen=True)
class EnvConfig:
    """Static configuration, the same fields and defaults as the JAX package's
    ``EnvConfig``. ``npc_mode`` is exact | serial | fast and ``npc_cleanup``
    slot | wave (core/npc.py); every ``lidar_impl`` of the JAX package runs
    kernel K1, since its lidar variants are bit-identical; ``npc_tier`` picks
    the widths to which ``VectorEnv`` narrows the NPC pool (envs/vector.py:
    0 none, > 0 that one, < 0 max_npcs // 4 then // 2); the env itself
    steps the pool at the width it is given.

    ``exact_trig`` and ``exact_obs`` are accepted for API parity and change
    nothing: the port always runs the reference float chain that the JAX
    package selects with both on (glibc-faithful sinf/cosf/tanf/atan2f/hypotf,
    IEEE divisions by device-resident constants, square roots taken in
    float64 and rounded once, every product rounded before its add), so every
    combination of the flags selects the same computation. The JAX package's
    ``_div32`` (ops/exact_trig.py:185) and ``sqrtf_exact``
    (ops/exact_libm.py:88) emulate an IEEE divide and square root on a TPU,
    whose own are not correctly rounded; they have no counterpart here, since
    CUDA's ``/`` and ``sqrtf`` (built with ``-prec-div=true -prec-sqrt=true``)
    are correctly rounded, and so is the float64 square root rounded to
    float32 that the port takes on the CPU."""

    num_agents: int = 1
    num_lanes: int = 3
    traffic_flow: bool = False
    traffic_density: float = 0.5
    use_team_reward: bool = False
    respawn_enabled: bool = True
    max_steps: int = 2000
    max_npcs: int = 32
    lidar_impl: str = "auto"
    npc_cleanup: str = "slot"
    npc_mode: str = "exact"
    npc_tier: int = -1
    exact_trig: bool = False
    exact_obs: bool = False

    def __post_init__(self):
        for name, allowed in (("npc_mode", ("exact", "serial", "fast")),
                              ("npc_cleanup", ("slot", "wave")),
                              ("lidar_impl", ("auto", "xla", "pallas", "interval", "sweep"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: one of {allowed}")


class EgoState(NamedTuple):
    """Per-ego arrays, shape (B, N)."""

    route_id: torch.Tensor        # int32
    x: torch.Tensor               # f32
    y: torch.Tensor
    v: torch.Tensor
    heading: torch.Tensor
    steering_angle: torch.Tensor
    path_index: torch.Tensor      # int32
    prev_dist_to_goal: torch.Tensor
    prev_acc_norm: torch.Tensor
    prev_steer_norm: torch.Tensor
    alive: torch.Tensor           # bool


class EnvState(NamedTuple):
    ego: EgoState
    lidar: torch.Tensor           # (B, N, 96) f32 distances
    step_count: torch.Tensor      # (B,) int32
    npc: Optional[NpcState] = None  # (B, max_npcs) pool; (B, 0) without traffic


class StepOutput(NamedTuple):
    obs: torch.Tensor             # (B, N, 127) f32
    reward: torch.Tensor          # (B, N) f32
    done: torch.Tensor            # (B, N) bool
    status: torch.Tensor          # (B, N) int32 (STATUS_*)
    terminated: torch.Tensor      # (B,) bool
    truncated: torch.Tensor       # (B,) bool
    agents_alive: torch.Tensor    # (B,) int32
    step: torch.Tensor            # (B,) int32
    spawned: torch.Tensor         # (B,) bool: an NPC spawned this tick


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]``; an index gather keeps the sign of -0.0."""
    return table[idx.long()]


class EgoTables(NamedTuple):
    """The route table's arrays the ego tick reads, indexed by route id."""

    paths: torch.Tensor           # (R, PATH_LEN, 2) f32
    goal_xy: torch.Tensor         # (R, 2)
    goal_prev_xy: torch.Tensor    # (R, 2)
    spawn_xy: torch.Tensor        # (R, 2)
    spawn_heading: torch.Tensor   # (R,)


class EgoTick(NamedTuple):
    """Sections 2-7 of a step: the egos' new state and the step's results."""

    ego: EgoState
    reward: torch.Tensor          # (B, N) f32
    done: torch.Tensor            # (B, N) bool
    status: torch.Tensor          # (B, N) int32
    agents_alive: torch.Tensor    # (B,) int32
    step_count: torch.Tensor      # (B,) int32, the incremented counter
    terminated: torch.Tensor      # (B,) bool
    truncated: torch.Tensor       # (B,) bool


def ego_step_ref(ego: EgoState, actions, dt_t, step_count, tables: EgoTables, npc,
                 cfg: EnvConfig, reward: RewardParams, max_progress: float) -> EgoTick:
    """Sections 2-7 of ``IntersectionEnv.step`` in plain PyTorch: the ego
    physics, path index and base reward, the per-ego status, the ordered
    collisions, the bonuses and team mix, the respawn, termination and
    truncation. The plain version of kernel K3 (ops/ego_step_cuda.py), which
    the CPU runs and the tests and chip_smoke.py hold the kernel to.

    actions (B, N, 2) f32; dt_t one f32; step_count (B,) int32, the counter
    before the step; npc: the NPC slots the egos collide with (``x``, ``y``,
    ``heading``, ``alive``, (B, w)), or None without traffic."""
    B, n = ego.x.shape
    dev = ego.x.device
    step_count = step_count + 1

    # --- 2) ego physics + base rewards (IntersectionEnv.cpp:151-163)
    alive = ego.alive
    ph = car_physics_step(ego.x, ego.y, ego.v, ego.heading, ego.steering_angle,
                          actions[..., 0], actions[..., 1], dt_t)
    x = torch.where(alive, ph.x, ego.x)
    y = torch.where(alive, ph.y, ego.y)
    v = torch.where(alive, ph.v, ego.v)
    heading = torch.where(alive, ph.heading, ego.heading)
    steering = torch.where(alive, ph.steering_angle, ego.steering_angle)
    acc = ph.acc

    pi = update_path_index(_pick(tables.paths, ego.route_id), PATH_LEN,
                           ego.path_index, x, y)
    pi = torch.where(alive, pi, ego.path_index)

    goal = _pick(tables.goal_xy, ego.route_id)                  # (B, N, 2)
    cur_dist = libm.hypotf_diff(x, goal[..., 0], y, goal[..., 1])
    r_prog = torch.where(ego.prev_dist_to_goal > 0.0,
                         libm.div(ego.prev_dist_to_goal - cur_dist, max_progress)
                         * reward.k_prog, 0.0)
    speed_ms = libm.div(v * FPS, SCALE)
    acc_norm = libm.div(acc, MAX_ACC)
    steer_norm = libm.div(steering, MAX_STEERING_ANGLE)
    d0 = acc_norm - ego.prev_acc_norm
    d1 = steer_norm - ego.prev_steer_norm
    r_smooth = (d0 * d0 + d1 * d1) * reward.k_sm
    r_stuck = torch.where(speed_ms < reward.v_min_ms, reward.k_stuck, 0.0)
    rewards = torch.where(alive, r_prog + r_stuck + r_smooth, 0.0)

    prev_dist = torch.where(alive, cur_dist, ego.prev_dist_to_goal)
    prev_acc_norm = torch.where(alive, acc_norm, ego.prev_acc_norm)
    prev_steer_norm = torch.where(alive, steer_norm, ego.prev_steer_norm)

    # --- 3) per-ego status (IntersectionEnv.cpp:166-290)
    goal_prev = _pick(tables.goal_prev_xy, ego.route_id)
    horiz = ((goal[..., 0] - goal_prev[..., 0]).abs()
             > (goal[..., 1] - goal_prev[..., 1]).abs())
    ex = (x - goal[..., 0]).abs()
    ey = (y - goal[..., 1]).abs()
    lat_err = torch.where(horiz, ey, ex)
    lon_err = torch.where(horiz, ex, ey)
    succ = (lat_err < 15.0) & (lon_err < 40.0)

    cn = car_corners(x, y, heading)                           # (B, N, 4, 2)
    cx_, cy_ = cn[..., 0], cn[..., 1]
    margin = 100.0
    oos = ((cx_ < -margin) | (cx_ > WIDTH + margin)
           | (cy_ < -margin) | (cy_ > HEIGHT + margin)).any(-1)
    offroad = (~is_on_road(cx_, cy_, cfg.num_lanes)).any(-1)
    line_a = hits_yellow_line(cx_, cy_, cfg.num_lanes).any(-1)
    mx = (cx_ + torch.roll(cx_, -1, dims=-1)) * 0.5
    my = (cy_ + torch.roll(cy_, -1, dims=-1)) * 0.5
    line_m = is_line_pixel(mx.to(_I), my.to(_I), cfg.num_lanes).any(-1)
    line_c = is_line_pixel(cx_.to(_I), cy_.to(_I), cfg.num_lanes).any(-1)
    hit_line = line_a | line_m | line_c

    status_new = torch.where(
        succ, STATUS_SUCCESS,
        torch.where(oos | offroad, STATUS_CRASH_WALL,
                    torch.where(hit_line, STATUS_CRASH_LINE, STATUS_ALIVE)))
    done_new = succ | oos | offroad | hit_line
    status = torch.where(alive, status_new, STATUS_DEAD).to(_I)
    done = torch.where(alive, done_new, True)

    # --- 4) ordered car-car collisions (IntersectionEnv.cpp:293-318)
    collide = sat_overlap(cn[:, :, None], heading[:, :, None],
                          cn[:, None, :], heading[:, None, :])   # (B, N, N)
    if npc is not None:
        npc_cn = car_corners(npc.x, npc.y, npc.heading)        # (B, M, 4, 2)
        npc_hit = (sat_overlap(cn[:, :, None], heading[:, :, None],
                               npc_cn[:, None, :], npc.heading[:, None, :])
                   & npc.alive[:, None, :]).any(-1)            # (B, N)
    jidx = torch.arange(n, device=dev)
    for i in range(n):
        row_ok = alive[:, i] & ~done[:, i]                     # (B,)
        jm = row_ok[:, None] & (jidx > i) & alive & ~done & collide[:, i]
        hit = jm.any(-1)
        if npc is not None:
            hit = hit | npc_hit[:, i]
        hit_i = row_ok & hit
        upd = jm | ((jidx == i) & hit_i[:, None])
        done = done | upd
        status = torch.where(upd, STATUS_CRASH_CAR, status).to(_I)

    # --- 5) terminal bonuses + team mixing (IntersectionEnv.cpp:321-336)
    is_crash_car = status == STATUS_CRASH_CAR
    is_crash_obj = (status == STATUS_CRASH_WALL) | (status == STATUS_CRASH_LINE)
    is_success = status == STATUS_SUCCESS
    rewards = rewards + torch.where(done & is_crash_car, reward.k_cv, 0.0)
    rewards = rewards + torch.where(done & is_crash_obj, reward.k_co, 0.0)
    rewards = rewards + torch.where(done & is_success, reward.k_succ, 0.0)
    if cfg.use_team_reward and n > 0:
        # the reference's ordered scalar sum from 0.0f (cpp:330-333):
        # 0.0 + (-0.0) = +0.0, so the seed is an explicit zero
        total = torch.zeros((B,), dtype=_F, device=dev) + rewards[:, 0]
        for i in range(1, n):
            total = total + rewards[:, i]
        avg = libm.div(total, float(n))
        one_minus = float(np.float32(1.0) - np.float32(reward.alpha))
        rewards = rewards * one_minus + avg[:, None] * reward.alpha

    # --- 6) respawn / terminated-on-done (IntersectionEnv.cpp:339-351)
    agents_alive = alive.sum(-1).to(_I)
    if cfg.respawn_enabled:
        crash = alive & done & (is_crash_car | is_crash_obj)
        sp_xy = _pick(tables.spawn_xy, ego.route_id)
        sp_h = _pick(tables.spawn_heading, ego.route_id)
        x = torch.where(crash, sp_xy[..., 0], x)
        y = torch.where(crash, sp_xy[..., 1], y)
        v = torch.where(crash, 0.0, v)
        heading = torch.where(crash, sp_h, heading)
        steering = torch.where(crash, 0.0, steering)
        pi = torch.where(crash, 0, pi).to(_I)
        prev_dist = torch.where(crash, 0.0, prev_dist)
        prev_acc_norm = torch.where(crash, 0.0, prev_acc_norm)
        prev_steer_norm = torch.where(crash, 0.0, prev_steer_norm)
        # --- 7) success termination (IntersectionEnv.cpp:353-366)
        succ_cnt = (alive & done & is_success).sum(-1).to(_I)
        terminated = (succ_cnt > 0) & (succ_cnt == agents_alive)
    else:
        terminated = done.any(-1)
    truncated = (step_count >= cfg.max_steps) if cfg.max_steps > 0 else \
        torch.zeros((B,), dtype=torch.bool, device=dev)

    new_ego = EgoState(
        route_id=ego.route_id, x=x, y=y, v=v, heading=heading,
        steering_angle=steering, path_index=pi, prev_dist_to_goal=prev_dist,
        prev_acc_norm=prev_acc_norm, prev_steer_norm=prev_steer_norm, alive=alive)

    return EgoTick(ego=new_ego, reward=rewards, done=done, status=status,
                   agents_alive=agents_alive, step_count=step_count, terminated=terminated,
                   truncated=truncated)


def ego_step(ego: EgoState, actions, dt_t, step_count, tables: EgoTables, npc,
             cfg: EnvConfig, reward: RewardParams, max_progress: float) -> EgoTick:
    """``ego_step_ref``: on the CPU itself, on the card one launch of K3."""
    args = (ego, actions, dt_t, step_count, tables, npc, cfg, reward, max_progress)
    if ego.x.device.type == "cpu":
        return ego_step_ref(*args)
    x, y, v, h, steering, prev_dist, prev_acc, prev_steer, rew, pi, status, done, \
        agents_alive, step_count, terminated, truncated = ego_step_cuda(*args)
    new_ego = EgoState(route_id=ego.route_id, x=x, y=y, v=v, heading=h, steering_angle=steering,
                       path_index=pi, prev_dist_to_goal=prev_dist, prev_acc_norm=prev_acc,
                       prev_steer_norm=prev_steer, alive=ego.alive)
    return EgoTick(ego=new_ego, reward=rew, done=done, status=status,
                   agents_alive=agents_alive, step_count=step_count, terminated=terminated,
                   truncated=truncated)


class IntersectionEnv:
    """Batched environment core on one device (``cuda`` unless ``device``
    says otherwise). With traffic, every step takes the tick's spawn draw
    from its caller (VectorEnv draws it).

    ``npc_stats``, a ``collections.Counter``, holds the env's counts and
    summed seconds of the steps with traffic, by key family:

      * ``host_reads``: the host's reads of the device (the NPC width read,
        the exact NPC loops' reads), a count; written by VectorEnv and the
        exact loops (core/npc.py), whatever runs the segments;
      * ``tier_reads``, ``step_width_<w>``: the width reads, and the steps
        run at width w (w = max_npcs for the full pool), counts
        (envs/vector.py);
      * ``cleanup_rounds``, ``collision_rounds``: the exact mode's cleanup
        and cascade rounds, counts (core/npc.py);
      * ``npc_rounds_at_<n>``: the exact ticks whose cleanup and cascade
        ran n rounds together, a count per n: the histogram of the loops'
        rounds a tick (``core.npc.exact_segments``);
      * ``read_idle_s.<cause>``: seconds, summed, from each host read of
        that cause (``width``, ``cleanup``, ``cascade``) to the return of
        the graph replay after it, in which the device idles; written only
        by the graphed step's runner (utils/graphs.py::Segments, on
        ``time.perf_counter_ns``); the eager runner (``utils.graphs.EAGER``),
        and so every CPU run, keeps the counts only.

    The counts of an eager and a graphed run of the same steps are equal
    (``utils.graphs.stat_counts``)."""

    def __init__(self, config: EnvConfig = EnvConfig(),
                 reward: Optional[RewardParams] = None,
                 table: Optional[RouteTable] = None, device=None):
        self.config = config
        self.reward = reward if reward is not None else RewardParams()
        self.table = table if table is not None else build_route_table(config.num_lanes)
        self.device = resolve_device(device)
        t, dev = self.table, self.device
        self.paths = torch.from_numpy(t.paths).to(dev)               # (R, P, 2)
        self.spawn_xy = torch.from_numpy(t.spawn_xy).to(dev)         # (R, 2)
        self.spawn_heading = torch.from_numpy(t.spawn_heading).to(dev)
        self.intent = torch.from_numpy(t.intent.astype(np.float32)).to(dev)
        self.goal_xy = torch.from_numpy(t.goal_xy).to(dev)
        self.goal_prev_xy = torch.from_numpy(t.goal_prev_xy).to(dev)
        self.traffic_ids = torch.from_numpy(t.traffic_route_ids).to(dev)
        self.tables = EgoTables(self.paths, self.goal_xy, self.goal_prev_xy, self.spawn_xy,
                                self.spawn_heading)
        self.npc_stats: collections.Counter = collections.Counter()
        # hypotf(750, 750) on the host libm, as the reference (cpp:22)
        self.max_progress = float(np.float32(np.hypot(np.float32(WIDTH), np.float32(HEIGHT))))

    # ------------------------------------------------------------------ reset
    def default_route_ids(self) -> np.ndarray:
        routes = default_ego_routes(self.config.num_agents, self.config.num_lanes)
        return self.table.route_ids(routes)

    def reset(self, route_ids=None, num_envs: int = 1) -> Tuple[EnvState, torch.Tensor]:
        """Fresh state (and its observation) with egos spawned on their routes
        (reference: env.py:147-161, cpp/IntersectionEnv.cpp:66-131)."""
        state = self.reset_state(route_ids, num_envs)
        return state, self.observe(state)

    def reset_state(self, route_ids=None, num_envs: int = 1) -> EnvState:
        """route_ids: (N,) or (B, N); None takes the default routes."""
        if route_ids is None:
            route_ids = self.default_route_ids()
        rid = torch.as_tensor(np.asarray(route_ids) if not torch.is_tensor(route_ids)
                              else route_ids, device=self.device).to(_I)
        if rid.dim() == 1:
            rid = rid[None].expand(num_envs, -1)
        B, n = rid.shape
        if n != self.config.num_agents:
            raise ValueError(f"route_ids has {n} agents, config {self.config.num_agents}")
        zeros = torch.zeros((B, n), dtype=_F, device=self.device)
        sp = _pick(self.spawn_xy, rid)
        ego = EgoState(
            route_id=rid.contiguous(),
            x=sp[..., 0].contiguous(), y=sp[..., 1].contiguous(), v=zeros,
            heading=_pick(self.spawn_heading, rid), steering_angle=zeros,
            path_index=torch.zeros((B, n), dtype=_I, device=self.device),
            prev_dist_to_goal=zeros, prev_acc_norm=zeros, prev_steer_norm=zeros,
            alive=torch.ones((B, n), dtype=torch.bool, device=self.device))
        # the first obs sees all-max lidar (IntersectionEnv.cpp:117)
        lidar = torch.full((B, n, LIDAR_RAYS), LIDAR_MAX_DIST, dtype=_F, device=self.device)
        cfg = self.config
        # the step counter and the pool's uid counter are two rows of one
        # zero fill, so the (B, 0) pool of a no-traffic reset costs no launch
        step_count, next_uid = torch.zeros((2, B), dtype=_I, device=self.device).unbind(0)
        npc = init_npc_state(B, cfg.max_npcs if cfg.traffic_flow else 0, self.device,
                             next_uid=next_uid)
        return EnvState(ego=ego, lidar=lidar, step_count=step_count, npc=npc)

    # ------------------------------------------------------------------- step
    def _traffic_args(self, state: EnvState, spawn, dt_t) -> tuple:
        """``npc_traffic_update``'s arguments for ``state`` and the spawn draw."""
        if spawn is None:
            raise ValueError("traffic_flow=True: step needs the tick's spawn draw")
        do_try, route_choice = (t.to(self.device) for t in spawn)
        ego = state.ego
        # every ego blocks a spawn, whatever its life state (TrafficFlow.cpp:245-250)
        return (state.npc, self.paths, self.goal_xy, self.spawn_xy, self.spawn_heading,
                self.traffic_ids, ego.x, ego.y, torch.ones_like(ego.alive), do_try,
                route_choice, dt_t)

    def exact_npc(self, state: EnvState, spawn, dt: float = DT_DEFAULT, run=EAGER,
                  key: tuple = ()):
        """The exact NPC mode's update of a tick up to its despawn, as device
        segments between the host's reads (core/npc.py::exact_segments), each
        run by ``run`` under ``key`` + its name: the carries that ``step``
        finishes when given them as ``npc_carries``. ``npc_stats`` counts
        the reads and rounds, and ``run`` may time the device's idle after
        each read (see the class docstring)."""
        dt_t = libm.const(dt, self.device)

        def begin(state, spawn):
            npc, paths, _, *rest = self._traffic_args(state, spawn, dt_t)
            return exact_begin(npc, paths, *rest)
        return exact_segments(begin, (state, spawn), self.config.npc_cleanup == "wave", dt_t,
                              self.npc_stats, run, key)

    def step(self, state: EnvState, actions: torch.Tensor, dt: float = DT_DEFAULT,
             with_obs: bool = True, spawn=None, npc_carries=None) -> Tuple[EnvState, StepOutput]:
        """actions (B, N, 2) float32 (throttle, steer) on the env's device.
        With traffic, ``spawn`` = (do_try (B,) bool, route_choice (B,) int)
        is the tick's NPC spawn draw (``core.npc.spawn_decision``); in the
        exact NPC mode, ``npc_carries`` (``exact_npc``'s result) stands for
        the NPC update up to its despawn when the caller ran it (the graphed
        step, envs/vector.py)."""
        cfg, rw, ego = self.config, self.reward, state.ego
        n = cfg.num_agents
        B = ego.x.shape[0]
        dev = self.device
        dt_t = libm.const(dt, dev)
        actions = actions.to(_F).reshape(B, n, 2).contiguous()

        # --- 1) NPC traffic (IntersectionEnv.cpp:140-142)
        npc = state.npc
        spawned = torch.zeros((B,), dtype=torch.bool, device=dev)
        if cfg.traffic_flow:
            if cfg.npc_mode == "fast":
                npc, spawned = npc_traffic_update_fast(*self._traffic_args(state, spawn, dt_t))
            elif cfg.npc_mode == "serial":
                npc, spawned = npc_traffic_update_serial(*self._traffic_args(state, spawn, dt_t))
            else:
                if npc_carries is None:
                    npc_carries = self.exact_npc(state, spawn, dt)
                npc, spawned = exact_end(npc_carries, self.goal_xy)

        # --- 2)-7) the ego tick (IntersectionEnv.cpp:151-366): ego_step_ref,
        # one launch of K3 on the card
        tick = ego_step(state.ego, actions, dt_t, state.step_count, self.tables,
                        npc if cfg.traffic_flow else None, cfg, rw, self.max_progress)
        x, y, heading, alive = tick.ego.x, tick.ego.y, tick.ego.heading, ego.alive

        # --- 8) lidar on the post-respawn state (IntersectionEnv.cpp:372-388):
        # every ego is an obstacle (the eps self-test skips the agent's own
        # slot), then the NPC slots, present when alive
        ones = torch.ones((B, n), dtype=torch.bool, device=dev)
        if cfg.traffic_flow:
            scan = lidar_scan(x, y, heading, torch.cat([x, npc.x], 1),
                              torch.cat([y, npc.y], 1), torch.cat([heading, npc.heading], 1),
                              torch.cat([ones, npc.alive], 1), cfg.num_lanes)
        else:
            scan = lidar_scan(x, y, heading, x, y, heading, ones, cfg.num_lanes)
        lidar = torch.where(alive[..., None], scan, state.lidar)

        new_state = EnvState(ego=tick.ego, lidar=lidar, step_count=tick.step_count, npc=npc)
        obs = self.observe(new_state) if with_obs else \
            torch.zeros((B, n, OBS_DIM), dtype=_F, device=dev)
        out = StepOutput(obs=obs, reward=tick.reward, done=tick.done, status=tick.status,
                         terminated=tick.terminated, truncated=tick.truncated,
                         agents_alive=tick.agents_alive, step=tick.step_count, spawned=spawned)
        return new_state, out

    # ------------------------------------------------------------ observation
    def observe(self, state: EnvState) -> torch.Tensor:
        """The (B, N, 127) observation (reference: IntersectionEnv.cpp:418-520):
        [0:4] ego x/W, y/H, v/vmax, heading/pi; [4:6] lookahead target
        distance/W and heading error/pi; [6:31] five nearest neighbours x
        {dx/W, dy/H, dv/vmax, dtheta/pi, intention} among the other egos and,
        with traffic, the alive NPCs; [31:127] lidar/250. Dead agents get
        all-zero rows."""
        n = self.config.num_agents
        ego = state.ego
        dev = self.device
        x, y, v, heading = ego.x, ego.y, ego.v, ego.heading
        B = x.shape[0]
        div = libm.div

        def dist2(a, b):
            return libm.sqrtf(a * a + b * b)

        o_base = torch.stack([div(x, WIDTH), div(y, HEIGHT),
                              div(v, PHYSICS_MAX_SPEED), div(heading, _PI32)], dim=-1)

        tgt = torch.clamp(ego.path_index + 10, max=PATH_LEN - 1)
        rid = ego.route_id.long()
        txy = self.paths[rid, tgt.long()]                          # (B, N, 2)
        dxd = txy[..., 0] - x
        dyd = txy[..., 1] - y
        d_dst = div(dist2(dxd, dyd), WIDTH)
        # atan2f(-dyd, dxd), the differences taken in the launch
        theta_err = div(wrap_angle(libm.atan2f_diff(txy[..., 1], y, txy[..., 0], x) - heading),
                        _PI32)

        # neighbour pool: the other egos (then the NPC slots), padded to
        # NEIGHBOR_COUNT slots
        kx, ky, kv, kh = x, y, v, heading
        ki = self.intent[rid]
        kmask = ego.alive
        if self.config.traffic_flow:
            npc = state.npc
            kx, ky, kv, kh = (torch.cat([a, b], 1) for a, b in
                              ((kx, npc.x), (ky, npc.y), (kv, npc.v), (kh, npc.heading)))
            ki = torch.cat([ki, self.intent[npc.route_id.long()]], 1)
            kmask = torch.cat([kmask, npc.alive], 1)
        if kx.shape[1] < NEIGHBOR_COUNT:
            pad = NEIGHBOR_COUNT - kx.shape[1]
            zf = torch.zeros((B, pad), dtype=_F, device=dev)
            kx, ky, kv, kh, ki = (torch.cat([t, zf], dim=1) for t in (kx, ky, kv, kh, ki))
            kmask = torch.cat([kmask, torch.zeros((B, pad), dtype=torch.bool, device=dev)], 1)
        k_tot = kx.shape[1]

        dist = dist2(kx[:, None, :] - x[..., None], ky[:, None, :] - y[..., None])  # (B,N,K)
        not_self = (torch.arange(k_tot, device=dev)[None, :]
                    != torch.arange(n, device=dev)[:, None])
        dmasked = torch.where(kmask[:, None, :] & not_self, dist, torch.inf)

        # top-5 nearest: masked argmin, lowest index on ties (the reference's
        # std::sort order, IntersectionEnv.cpp:490); empty slots stay zero
        rows = []
        for _ in range(NEIGHBOR_COUNT):
            j = torch.argmin(dmasked, dim=-1, keepdim=True)         # (B, N, 1)
            valid = torch.isfinite(dmasked.gather(-1, j))[..., 0]
            dmasked = dmasked.scatter(-1, j, torch.inf)

            def pick(a):
                return a[:, None, :].expand(B, n, k_tot).gather(-1, j)[..., 0]

            feat = torch.stack([
                div(pick(kx) - x, WIDTH),
                div(pick(ky) - y, HEIGHT),
                div(pick(kv) - v, PHYSICS_MAX_SPEED),
                div(wrap_angle(pick(kh) - heading), _PI32),
                pick(ki),
            ], dim=-1)
            rows.append(torch.where(valid[..., None], feat, 0.0))
        nfeat = torch.stack(rows, dim=-2).reshape(B, n, 5 * NEIGHBOR_COUNT)

        # the reference multiplies by a precomputed reciprocal (Lidar.cpp:95-97)
        inv = float(np.float32(1.0) / np.float32(LIDAR_MAX_DIST))
        o_lidar = state.lidar * inv

        obs = torch.cat([o_base, torch.stack([d_dst, theta_err], -1), nfeat, o_lidar], -1)
        return torch.where(ego.alive[..., None], obs, 0.0)
