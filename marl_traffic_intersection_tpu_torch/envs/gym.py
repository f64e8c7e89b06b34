"""Gym-style stateful wrapper with the reference's Python API surface.

Counterpart of marl_traffic_intersection_tpu/envs/gym.py, a drop-in analogue
of the reference ``IntersectionEnv`` (reference: env.py:80-221): config-dict
construction, ``reset() -> (obs, info)``,
``step(actions, dt) -> (obs, rewards, terminated, truncated, info)`` with the
single-agent-vs-multi-agent return-shape switch, and ``render()`` delegating
to the host-side debug renderer. Internally it drives the port's batched
core with one env and keeps its ``EnvState`` as the only mutable slot; obs,
rewards and info come back to the host in one copy per step.

It runs on the card unless the config says ``"device": "cpu"``. Every step
launches kernel K1 once (1 x N agents; with traffic, against the egos and
the 32 NPC slots). ``"backend": "native"`` steps the host C++ engine
(native/) instead, a caller's choice for microsecond latency; any other
backend than ``"torch"`` (the default) and ``"native"`` raises.

With traffic, each step's NPC spawn draw comes from a ``torch.Generator``
on the device seeded by the reset's seed (``core.npc.spawn_decision``), or
from ``spawn_sampler(1) -> (do_try (1,), route_choice (1,))`` when one is
given, as ``VectorEnv`` takes it: torch cannot replay jax.random's stream,
so tests feed the JAX package's draws in that way. A step's ``dt`` reaches
the physics as a float32 device constant (``ops/libm.const``).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..compat import host_state
from ..core.constants import DT_DEFAULT, OBS_DIM, STATUS_NAMES
from ..core.env import EnvConfig, IntersectionEnv, RewardParams
from ..core.npc import spawn_decision
from ..core.routes import default_ego_routes
from ..device import resolve_device

# Mirrors the reference DEFAULT_REWARD_CONFIG (env.py:41-54)
DEFAULT_REWARD_CONFIG = {
    "use_team_reward": False,
    "traffic_flow": False,
    "reward_config": {
        "progress_scale": 10.0,
        "stuck_speed_threshold": 1.0,
        "stuck_penalty": -0.01,
        "crash_vehicle_penalty": -10.0,
        "crash_object_penalty": -5.0,
        "success_reward": 10.0,
        "action_smoothness_scale": -0.02,
        "team_alpha": 0.2,
    },
}

# the reference's Python reward-config keys (env.py:57-77) -> RewardParams
_REWARD_KEYS = {"progress_scale": "k_prog", "stuck_speed_threshold": "v_min_ms",
                "stuck_penalty": "k_stuck", "crash_vehicle_penalty": "k_cv",
                "crash_object_penalty": "k_co", "success_reward": "k_succ",
                "action_smoothness_scale": "k_sm", "team_alpha": "alpha"}

BACKENDS = ("torch", "native")


def reward_params(d: Dict[str, float]) -> RewardParams:
    """RewardParams from the reference's Python reward-config keys, float32
    values; other keys are ignored (the JAX package's ``RewardParams.from_dict``)."""
    return RewardParams(**{_REWARD_KEYS[k]: float(np.float32(v)) for k, v in d.items()
                           if k in _REWARD_KEYS})


class RawEnvView:
    """The raw binding's attribute + event surface (cpp/bindings.cpp:64-82).

    The reference's pybind11 env object exposes ``cars``, ``traffic_cars``,
    ``lidars`` and ``step_count`` as live attributes (bindings.cpp:66-69)
    alongside the GLFW queries (``poll_events``/``key_pressed``/
    ``window_should_close``, bindings.cpp:80-82). This view reproduces the
    whole idiom on ``GymIntersectionEnv.env``: attribute reads materialize
    ``compat.Car``/``compat.Lidar`` snapshots of the current state, moved to
    the host (value semantics: the attributes are per-read snapshots, not
    aliased references; a documented deviation, PARITY.md). Event queries
    go to an EventSurface.
    """

    def __init__(self, owner: "GymIntersectionEnv"):
        from .events import EventSurface
        self._owner = owner
        self._events = EventSurface()

    # ----------------------------------------------- event surface delegation
    def poll_events(self) -> None:
        self._events.poll_events()

    def key_pressed(self, glfw_key: int) -> bool:
        return self._events.key_pressed(glfw_key)

    def window_should_close(self) -> bool:
        return self._events.window_should_close()

    def __getattr__(self, name):
        # anything else (inject_press, attach_matplotlib, request_close, ...)
        # falls through to the event surface
        return getattr(self._events, name)

    # ----------------------------------------------- raw attribute surface
    def _state(self):
        return self._owner._host_view()

    @property
    def cars(self):
        """Ego fleet as compat.Car objects (bindings.cpp:66)."""
        from ..compat import Car
        st = self._state()
        paths = self._owner._core.table.paths
        return [Car.from_env_state(st, i, paths) for i in range(self._owner.num_agents)]

    @property
    def traffic_cars(self):
        """Alive NPCs as compat.Car objects in spawn (uid) order, the
        reference's ``traffic_cars`` vector order (bindings.cpp:67)."""
        from ..compat import Car
        st = self._state()
        paths = self._owner._core.table.paths
        idx = np.nonzero(np.asarray(st.npc.alive))[0]
        if hasattr(st.npc, "uid"):
            uid = np.asarray(st.npc.uid)
            idx = idx[np.argsort(uid[idx], kind="stable")]
        return [Car.from_npc_state(st, int(i), paths) for i in idx]

    @property
    def lidars(self):
        """Per-ego sensors with the env's 96-ray config and the latest
        distances (bindings.cpp:68, IntersectionEnv.cpp:113-127)."""
        from ..compat import Lidar
        dists = np.asarray(self._state().lidar)
        out = []
        for i in range(self._owner.num_agents):
            s = Lidar.env_sensor()
            s.distances = [float(d) for d in dists[i]]
            out.append(s)
        return out

    @property
    def step_count(self) -> int:
        return int(np.asarray(self._state().step_count))


class GymIntersectionEnv:
    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 spawn_sampler: Optional[Callable[[int], Tuple[torch.Tensor,
                                                               torch.Tensor]]] = None):
        if config is None:
            config = {}
        self.traffic_flow = bool(config.get("traffic_flow", False))
        self.num_agents = 1 if self.traffic_flow else int(config.get("num_agents", 1))
        self.num_lanes = int(config.get("num_lanes", 3))
        self.render_mode = config.get("render_mode", None)
        self.show_lane_ids = bool(config.get("show_lane_ids", False))
        self.show_lidar = bool(config.get("show_lidar", False))
        self.backend = str(config.get("backend", "torch"))
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: one of {BACKENDS}")

        use_team = bool(config.get("use_team_reward",
                                   DEFAULT_REWARD_CONFIG["use_team_reward"]))
        if self.traffic_flow:
            use_team = False

        reward_cfg = config.get("reward_config")
        if reward_cfg is None:
            reward_cfg = DEFAULT_REWARD_CONFIG["reward_config"]
        reward = reward_params(reward_cfg) if isinstance(reward_cfg, dict) else RewardParams()

        self._cfg = EnvConfig(
            num_agents=self.num_agents,
            num_lanes=self.num_lanes,
            traffic_flow=self.traffic_flow,
            traffic_density=float(config.get("traffic_density", 0.5)),
            use_team_reward=use_team,
            respawn_enabled=bool(config.get("respawn_enabled", True)),
            max_steps=int(config.get("max_steps", 2000)),
            max_npcs=int(config.get("max_npcs", 32)),
            # accepted for the JAX package's sake: the port always runs the
            # reference float chain (core/env.py)
            exact_trig=bool(config.get("exact_trig", False)),
            exact_obs=bool(config.get("exact_obs", False)),
        )
        self.device = resolve_device(config.get("device"))
        self._core = IntersectionEnv(self._cfg, reward=reward, device=self.device)
        self._reward = reward
        self._native = None
        if self.backend == "native":
            from ..native import NativeEngine
            r = reward
            self._native = NativeEngine(
                num_lanes=self.num_lanes, use_team=use_team,
                respawn=self._cfg.respawn_enabled, max_steps=self._cfg.max_steps,
                traffic=self.traffic_flow, density=self._cfg.traffic_density,
                max_npcs=self._cfg.max_npcs, seed=int(config.get("seed", 0)),
                reward=[float(r.k_prog), float(r.v_min_ms), float(r.k_stuck),
                        float(r.k_cv), float(r.k_co), float(r.k_succ),
                        float(r.k_sm), float(r.alpha)])
        self.lane_layout = self._core.table.layout
        self.points = self.lane_layout["points"]

        self.ego_routes: List[Tuple[str, str]] = config.get("ego_routes") or \
            default_ego_routes(self.num_agents, self.num_lanes)

        self._seed = int(config.get("seed", 0))
        self.generator = torch.Generator(device=self.device)
        self.spawn_sampler = spawn_sampler
        self._state = None
        self._renderer = None

        # GLFW-style event surface + raw attribute surface: the reference
        # harness reaches through the wrapper for input polling
        # (`env.env.poll_events()` / `.key_pressed(k)` /
        # `.window_should_close()`, test.py:110-145, cpp/bindings.cpp:80-82)
        # and the raw binding exposes `cars` / `traffic_cars` / `lidars` /
        # `step_count` as live attributes (cpp/bindings.cpp:66-70).
        self.env = RawEnvView(self)

        self.reset()

    # ------------------------------------------------------------------- api
    @property
    def state(self):
        """Current EnvState snapshot (value semantics; cf. get_state/set_state)."""
        return self._state

    @state.setter
    def state(self, s):
        self._state = s

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._seed = seed
        rids = self._core.table.route_ids(self.ego_routes)
        self._state, obs_t = self._core.reset(rids)
        self.generator.manual_seed(self._seed)
        if self._native is not None:
            # the native engine answers the whole native-backend API, reset
            # included: its own reset-time observation (all-max lidar,
            # reference env.py:158 / IntersectionEnv.cpp:117). The state
            # above is kept only as the renderer/snapshot mirror.
            self._native.reset([int(r) for r in rids])
            obs = self._native.observations()
        else:
            obs = obs_t[0].cpu().numpy()
        self._seed += 1
        if self.traffic_flow:
            return obs[0], {}
        return obs, {}

    def _spawn(self, dt: float):
        if self.spawn_sampler is not None:
            do_try, route = self.spawn_sampler(1)
        else:
            do_try, route = spawn_decision(self.generator, 1, self._core.traffic_ids.shape[0],
                                           self._cfg.traffic_density, dt)
        return (torch.as_tensor(do_try, device=self.device).reshape(1),
                torch.as_tensor(route, device=self.device).reshape(1).to(torch.int32))

    def step(self, actions: Union[np.ndarray, List], dt: float = DT_DEFAULT):
        actions = np.asarray(actions, dtype=np.float32)
        if self.traffic_flow:
            actions = actions.reshape(1, 2)
        elif actions.ndim == 1:
            if actions.size == 2 and self.num_agents == 1:
                actions = actions.reshape(1, 2)
            else:
                raise ValueError(
                    f"Expected actions shape (N,2) for multi-agent, got {actions.shape}")

        n = self.num_agents
        if self._native is not None:
            r = self._native.step(actions, dt=float(dt))
            obs = r["obs"]
            rewards = r["reward"]
            terminated = r["terminated"]
            truncated = r["truncated"]
            status = [STATUS_NAMES[int(s)] for s in r["status"]]
            done = [int(d) for d in r["done"]]
            step_no = r["step"]
            agents_alive = r["agents_alive"]
        else:
            a = torch.from_numpy(np.ascontiguousarray(actions)).to(self.device)[None]
            spawn = self._spawn(float(dt)) if self.traffic_flow else None
            self._state, out = self._core.step(self._state, a, float(dt), spawn=spawn)
            # everything the step returns, in one copy to the host (float32
            # holds the integers exactly)
            packed = torch.cat([
                out.obs[0].reshape(-1), out.reward[0], out.status[0].float(),
                out.done[0].float(),
                torch.stack([out.terminated[0].float(), out.truncated[0].float(),
                             out.agents_alive[0].float(), out.step[0].float()])]).cpu().numpy()
            obs = packed[:n * OBS_DIM].reshape(n, OBS_DIM)
            rewards = packed[n * OBS_DIM:n * (OBS_DIM + 1)]
            status = [STATUS_NAMES[int(s)] for s in packed[n * (OBS_DIM + 1):n * (OBS_DIM + 2)]]
            done = [int(d) for d in packed[n * (OBS_DIM + 2):n * (OBS_DIM + 3)]]
            tail = packed[n * (OBS_DIM + 3):]
            terminated, truncated = bool(tail[0]), bool(tail[1])
            agents_alive, step_no = int(tail[2]), int(tail[3])

        # agent ids are stable slot indices + 1 (reference ids start at 1,
        # IntersectionEnv.cpp:130; egos are never removed so they coincide)
        collisions = {i + 1: status[i] for i in range(n)}

        info = {
            "step": step_no,
            "rewards": rewards.tolist() if not self.traffic_flow else float(rewards[0]),
            "collisions": collisions,
            "agents_alive": agents_alive,
            "terminated": terminated,
            "truncated": truncated,
            "done": done,
            "status": status,
        }
        if self.traffic_flow:
            return obs[0], float(rewards[0]), terminated, truncated, info
        return obs, rewards, terminated, truncated, info

    def render(self, show_lane_ids: Optional[bool] = None,
               show_lidar: Optional[bool] = None):
        if self.render_mode not in ("human", "rgb_array"):
            return None
        if show_lane_ids is None:
            show_lane_ids = self.show_lane_ids
        if show_lidar is None:
            show_lidar = self.show_lidar
        if self._renderer is None:
            from ..render.draw import Renderer
            self._renderer = Renderer(self._core)
        frame = self._renderer.render(self._host_view(), show_lane_ids=show_lane_ids,
                                      show_lidar=show_lidar)
        if self.render_mode == "human":
            self._renderer.show(frame)
        return frame

    def _host_view(self) -> SimpleNamespace:
        """The current state on the host (``compat.host_state``)."""
        if self._native is not None:
            return self._native_state_view()
        return host_state(self._state)

    def _native_state_view(self) -> SimpleNamespace:
        """Minimal host-state view over the native engine, for rendering."""
        eg = self._native.egos()
        npcs = self._native.npcs()
        ego = SimpleNamespace(
            x=eg[:, 0], y=eg[:, 1], v=eg[:, 2], heading=eg[:, 3],
            steering_angle=eg[:, 4], alive=eg[:, 6] > 0.5,
            route_id=self._core.table.route_ids(self.ego_routes),
            path_index=eg[:, 5].astype(np.int32))
        npc = SimpleNamespace(
            alive=np.ones(len(npcs), bool), x=npcs[:, 0], y=npcs[:, 1],
            heading=npcs[:, 3])
        lidar = np.stack([self._native.lidar(i) for i in range(self.num_agents)]) \
            if self.num_agents else np.zeros((0, 96), np.float32)
        return SimpleNamespace(ego=ego, npc=npc, lidar=lidar,
                               step_count=self._native._lib.mti_step_count(self._native._h))

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None
