"""Object-level reference-API compatibility layer.

Counterpart of marl_traffic_intersection_tpu/compat.py. The reference's
pybind11 module exposes standalone ``State``, ``Car``, ``RewardConfig``,
``StepResult`` and ``Lidar`` classes that users can instantiate and drive
directly (reference: cpp/bindings.cpp:11-95, cpp_backend.py:53-66). The
port's core is batched and functional, so these are thin mutable host-side
shims over the same arithmetic:

  * ``Car.update``            -> the bicycle step of cpp/Car.cpp:9-40, in
                                 numpy float32, op for op the arithmetic of
                                 core/physics.car_physics_step, its tanf,
                                 cosf and sinf the host glibc's through
                                 ops/libm.py (numpy's float32 trig differs
                                 from glibc's on 11-23% of inputs)
  * ``Car.corners``           -> cpp/Car.cpp:86-103
  * ``Car.check_collision``   -> SAT, cpp/Car.cpp:105-141
  * ``Car.update_path_index`` -> windowed nearest point, cpp/Car.cpp:47-74
  * ``Car.respawn``           -> cpp/Car.cpp:76-84
  * ``Lidar.update``          -> the 4-px ray march of cpp/Lidar.cpp:16-91
                                 (ops/lidar_cuda.lidar_scan for the env's
                                 sensor, the plain march for other sensors)

They interop with the batched environment: ``Car.from_env_state`` loads a
slot of any env of an ``EnvState`` (``host_state`` moves that env to the
host first).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.constants import (CAR_LENGTH, CAR_WIDTH, LIDAR_FOV_DEG, LIDAR_MAX_DIST,
                             LIDAR_RAYS, LIDAR_STEP, MAX_ACC, MAX_STEERING_ANGLE,
                             PHYSICS_MAX_SPEED, WHEELBASE)
from .ops import libm

_F = np.float32
_PI = _F(np.pi)


def _trig(name: str, x) -> np.float32:
    """The host glibc's float ``name`` of one float32 value (ops/libm.py)."""
    return libm.glibc_np(name, np.asarray([x], _F))[0]


def host_state(state, env: int = 0) -> SimpleNamespace:
    """Env ``env`` of an ``EnvState`` on the host: namespaces ``ego`` and
    ``npc`` of numpy arrays over the agent and NPC slots, ``lidar`` (N, 96)
    and ``step_count``. A state already on the host (such a namespace) is
    returned as it is."""
    if not torch.is_tensor(state.ego.x):
        return state

    def fields(tup):
        return SimpleNamespace(**{f: getattr(tup, f)[env].cpu().numpy() for f in tup._fields})

    return SimpleNamespace(ego=fields(state.ego), npc=fields(state.npc),
                           lidar=state.lidar[env].cpu().numpy(),
                           step_count=state.step_count[env].cpu().numpy())


@dataclasses.dataclass
class State:
    """Kinematic state (reference: cpp/Car.h:9-14)."""

    x: float = 0.0
    y: float = 0.0
    v: float = 0.0        # px/frame
    heading: float = 0.0  # radians, y-up convention on a y-down screen


@dataclasses.dataclass
class RewardConfig:
    """Reward knobs with the reference defaults (cpp/Reward.h:5-14)."""

    k_prog: float = 10.0
    v_min_ms: float = 1.0
    k_stuck: float = -0.01
    k_cv: float = -10.0
    k_co: float = -5.0
    k_succ: float = 10.0
    k_sm: float = -0.02
    alpha: float = 0.2


@dataclasses.dataclass
class StepResult:
    """Step payload mirror (reference: cpp/Reward.h:16-29)."""

    obs: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 127), _F))
    rewards: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, _F))
    done: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    status: List[str] = dataclasses.field(default_factory=list)
    agent_ids: List[int] = dataclasses.field(default_factory=list)
    agents_alive: int = 0
    terminated: bool = False
    truncated: bool = False
    step: int = 0


def _t(*xs) -> List[torch.Tensor]:
    return [torch.tensor(_F(x)) for x in xs]


class Car:
    """Mutable single-car shim over the functional physics."""

    def __init__(self):
        self.state = State()
        self.length = float(CAR_LENGTH)
        self.width = float(CAR_WIDTH)
        self.acc = 0.0
        self.steering_angle = 0.0
        self.alive = True
        self.spawn_state = State()
        self.intention = 0
        self.path: List[Tuple[float, float]] = []
        self.path_index = 0
        self.prev_dist_to_goal = 0.0
        self.prev_action = (0.0, 0.0)

    # -- physics (cpp/Car.cpp:9-40; identical quirks: per-call steering lag,
    #    float-equality decay, dt only on the speed update)
    def update(self, throttle: float, steer_input: float, dt: float) -> None:
        th = _F(throttle)
        self.acc = float(th * _F(MAX_ACC))
        target = _F(steer_input) * _F(MAX_STEERING_ANGLE)
        sa = _F(self.steering_angle)
        sa = sa + (target - sa) * _F(0.2)
        self.steering_angle = float(sa)

        v = _F(self.state.v)
        if th == _F(0.0):
            v = v * _F(0.95)
        v = v + _F(self.acc) * _F(dt)
        v = min(max(v, _F(0.0)), _F(PHYSICS_MAX_SPEED))

        heading = _F(self.state.heading)
        if np.abs(v) > _F(0.1):
            heading = heading + (v / _F(WHEELBASE)) * _trig("tanf", sa)
        heading = np.fmod(heading + _PI, _F(2.0) * _PI)
        if heading < _F(0.0):
            heading = heading + _F(2.0) * _PI
        heading = heading - _PI

        self.state.v = float(v)
        self.state.heading = float(heading)
        self.state.x = float(_F(self.state.x) + v * _trig("cosf", heading))
        self.state.y = float(_F(self.state.y) - v * _trig("sinf", heading))

    # -- geometry (cpp/Car.cpp:86-103)
    def corners(self) -> np.ndarray:
        from .core.physics import car_corners

        return car_corners(*_t(self.state.x, self.state.y, self.state.heading)).numpy()

    # -- SAT collision (cpp/Car.cpp:105-141)
    def check_collision(self, other: "Car") -> bool:
        from .core.physics import car_corners, sat_overlap

        xa, ya, ha = _t(self.state.x, self.state.y, self.state.heading)
        xb, yb, hb = _t(other.state.x, other.state.y, other.state.heading)
        return bool(sat_overlap(car_corners(xa, ya, ha), ha, car_corners(xb, yb, hb), hb))

    # -- path following (cpp/Car.cpp:42-74)
    def set_path(self, p: Sequence[Tuple[float, float]]) -> None:
        self.path = [(float(a), float(b)) for a, b in p]
        self.path_index = 0

    def update_path_index(self) -> None:
        if not self.path:
            self.path_index = 0
            return
        from .core.physics import update_path_index

        path = torch.from_numpy(np.asarray(self.path, _F))
        x, y = _t(self.state.x, self.state.y)
        self.path_index = int(update_path_index(path, path.shape[0],
                                                torch.tensor(self.path_index, dtype=torch.int32),
                                                x, y))

    # -- lifecycle (cpp/Car.cpp:76-84)
    def respawn(self) -> None:
        self.state = dataclasses.replace(self.spawn_state)
        self.alive = True
        self.path_index = 0
        self.prev_dist_to_goal = 0.0
        self.prev_action = (0.0, 0.0)
        self.acc = 0.0
        self.steering_angle = 0.0

    # -- env interop
    @classmethod
    def from_env_state(cls, state, slot: int, paths: Optional[np.ndarray] = None,
                       env: int = 0) -> "Car":
        """Load ego slot ``slot`` of env ``env`` of an ``EnvState`` (or of a
        ``host_state`` view) into a Car."""
        car = cls()
        ego = host_state(state, env).ego
        car.state = State(float(ego.x[slot]), float(ego.y[slot]), float(ego.v[slot]),
                          float(ego.heading[slot]))
        car.steering_angle = float(ego.steering_angle[slot])
        car.alive = bool(ego.alive[slot])
        car.path_index = int(ego.path_index[slot])
        if paths is not None:
            car.set_path(np.asarray(paths)[int(ego.route_id[slot])])
            car.path_index = int(ego.path_index[slot])
        return car

    @classmethod
    def from_npc_state(cls, state, slot: int, paths: Optional[np.ndarray] = None,
                       env: int = 0) -> "Car":
        """Load NPC slot ``slot`` of env ``env`` into a Car (the reference
        exposes NPCs as plain Car objects in ``env.traffic_cars``,
        cpp/bindings.cpp:67)."""
        car = cls()
        npc = host_state(state, env).npc
        g = lambda name, d=0.0: (float(getattr(npc, name)[slot]) if hasattr(npc, name) else d)
        car.state = State(g("x"), g("y"), g("v"), g("heading"))
        car.steering_angle = g("steering_angle")
        car.alive = bool(npc.alive[slot])
        if hasattr(npc, "path_index"):
            car.path_index = int(npc.path_index[slot])
        if paths is not None and hasattr(npc, "route_id"):
            pi = car.path_index
            car.set_path(np.asarray(paths)[int(npc.route_id[slot])])
            car.path_index = pi
        return car


class Lidar:
    """Standalone beam sensor with the reference's defaults (cpp/Lidar.h:10-14:
    72 rays; the env overrides to 96 at car creation, as ``IntersectionEnv``
    here does too)."""

    def __init__(self, rays: int = 72, fov_deg: float = 360.0,
                 max_dist: float = 250.0, step_size: float = 4.0):
        self.rays = int(rays)
        self.fov_deg = float(fov_deg)
        self.max_dist = float(max_dist)
        self.step_size = float(step_size)
        from .core.lidar import ray_rel_angles

        self.rel_angles = ray_rel_angles(self.rays, self.fov_deg).tolist()
        self.distances = [self.max_dist] * self.rays

    @classmethod
    def env_sensor(cls) -> "Lidar":
        """The env's actual sensor config (IntersectionEnv.cpp:113-127)."""
        return cls(LIDAR_RAYS, LIDAR_FOV_DEG, LIDAR_MAX_DIST, LIDAR_STEP)

    def update(self, self_car: Car, cars: Sequence[Car], num_lanes: int = 3) -> None:
        """Ray march against off-road geometry + other cars' rotated-rect
        AABBs (cpp/Lidar.cpp:16-91). ``cars`` may include ``self_car``; it is
        excluded by the same epsilon pose compare as the reference."""
        from .core.lidar import lidar_scan_ref
        from .ops.lidar_cuda import lidar_scan

        m = max(len(cars), 1)
        ob = np.zeros((3, 1, m), _F)
        mask = np.zeros((1, m), bool)
        for i, c in enumerate(cars):
            ob[:, 0, i] = c.state.x, c.state.y, c.state.heading
            mask[0, i] = True
        me = [torch.tensor([[_F(v)]]) for v in (self_car.state.x, self_car.state.y,
                                                 self_car.state.heading)]
        args = (*me, *map(torch.from_numpy, ob), torch.from_numpy(mask))
        geometry = (self.rays, self.fov_deg, self.max_dist, self.step_size)
        if geometry == (LIDAR_RAYS, LIDAR_FOV_DEG, LIDAR_MAX_DIST, LIDAR_STEP):
            d = lidar_scan(*args, num_lanes=num_lanes)
        else:
            d = lidar_scan_ref(*args, num_lanes=num_lanes, rays=self.rays, fov_deg=self.fov_deg,
                               max_dist=self.max_dist, step_size=self.step_size)
        self.distances = [float(v) for v in d[0, 0]]

    def normalized(self) -> List[float]:
        inv = 1.0 / self.max_dist if self.max_dist > 0 else 0.0
        return [d * inv for d in self.distances]
