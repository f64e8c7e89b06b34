"""Strict Gymnasium adapters over the port's batched core.

Counterpart of marl_traffic_intersection_tpu/envs/gymnasium_compat.py. The
reference exposes a Gym-*style* API but is not registrable with the
Gymnasium ecosystem (reference env.py returns bespoke tuples; no spaces, no
``gymnasium.Env`` base). These adapters make the port's env a first-class
citizen for external tooling (SB3/CleanRL-style trainers, wrappers, env
checkers):

  - ``GymnasiumIntersectionEnv``: single-agent ``gymnasium.Env`` (passes
    ``gymnasium.utils.env_checker.check_env``). Gymnasium's API is
    single-agent by design; multi-agent users take ``envs.gym.GymIntersectionEnv``
    (reference API parity) or the batched ``envs.vector.VectorEnv``.
  - ``GymnasiumVectorEnv``: ``gymnasium.vector.VectorEnv`` over the port's
    ``VectorEnv`` with SAME_STEP autoreset (done envs start a fresh episode
    inside the same batched step) and the terminal observation in
    ``final_obs``.

Both run on the card unless the config says ``"device": "cpu"``, and speak
numpy at the boundary. gymnasium is imported only if it is installed; the
adapters raise ImportError without it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.constants import STATUS_NAMES
from ..core.env import EnvConfig, IntersectionEnv
from ..core.npc import spawn_decision
from ..core.routes import default_ego_routes
from ..device import resolve_device
from .gym import reward_params
from .vector import VectorEnv

try:  # gymnasium is optional (absent on the card's machine)
    import gymnasium
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    gymnasium = None
    spaces = None


def _require_gymnasium():
    if gymnasium is None:  # pragma: no cover
        raise ImportError("gymnasium is not installed")


def _build_core(config: Optional[Dict[str, Any]]):
    config = dict(config or {})
    reward_cfg = config.get("reward_config")
    reward = reward_params(reward_cfg) if isinstance(reward_cfg, dict) else None
    cfg = EnvConfig(
        num_agents=int(config.get("num_agents", 1)),
        num_lanes=int(config.get("num_lanes", 3)),
        traffic_flow=bool(config.get("traffic_flow", False)),
        traffic_density=float(config.get("traffic_density", 0.5)),
        use_team_reward=bool(config.get("use_team_reward", False)),
        respawn_enabled=bool(config.get("respawn_enabled", True)),
        max_steps=int(config.get("max_steps", 2000)),
        max_npcs=int(config.get("max_npcs", 32)),
    )
    core = IntersectionEnv(cfg, reward=reward, device=resolve_device(config.get("device")))
    routes = config.get("ego_routes") or default_ego_routes(cfg.num_agents, cfg.num_lanes)
    return core, cfg, routes


class GymnasiumIntersectionEnv(*([] if gymnasium is None else [gymnasium.Env])):
    """Single-agent strict ``gymnasium.Env`` over the port's core."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 60}

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 render_mode: Optional[str] = None):
        _require_gymnasium()
        config = dict(config or {})
        if int(config.get("num_agents", 1)) != 1:
            raise ValueError(
                "GymnasiumIntersectionEnv is single-agent (gymnasium API); "
                "use envs.gym.GymIntersectionEnv or envs.vector.VectorEnv "
                "for multi-agent")
        config["num_agents"] = 1
        self._core, self._cfg, self._routes = _build_core(config)
        self._rids = self._core.table.route_ids(self._routes)
        self._generator = torch.Generator(device=self._core.device)
        self._state = None
        self._seed = int(config.get("seed", 0))
        self.render_mode = render_mode
        self._renderer = None

        self.observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=(127,), dtype=np.float32)
        self.action_space = spaces.Box(
            low=-1.0, high=1.0, shape=(2,), dtype=np.float32)

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._seed = seed
        self._state, obs = self._core.reset(self._rids)
        self._generator.manual_seed(self._seed)      # the NPC spawn draws
        self._seed += 1
        return obs[0, 0].cpu().numpy(), {}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        core = self._core
        a = torch.from_numpy(np.asarray(action, np.float32).reshape(1, 1, 2)).to(core.device)
        spawn = spawn_decision(self._generator, 1, core.traffic_ids.shape[0],
                               self._cfg.traffic_density, 1.0 / 60.0) \
            if self._cfg.traffic_flow else None
        self._state, out = core.step(self._state, a, spawn=spawn)
        info = {"status": STATUS_NAMES[int(out.status[0, 0])], "step": int(out.step[0]),
                "agents_alive": int(out.agents_alive[0])}
        return (out.obs[0, 0].cpu().numpy(), float(out.reward[0, 0]),
                bool(out.terminated[0]), bool(out.truncated[0]), info)

    def render(self):
        if self.render_mode != "rgb_array":
            return None
        if self._state is None:
            raise RuntimeError("call reset() before render()")
        if self._renderer is None:
            from ..render.draw import Renderer
            self._renderer = Renderer(self._core)
        return np.asarray(self._renderer.render(self._state))

    def close(self):
        self._renderer = None


class GymnasiumVectorEnv(
        *([] if gymnasium is None else [gymnasium.vector.VectorEnv])):
    """``gymnasium.vector.VectorEnv`` over the port's batched step.

    One batched step advances all ``num_envs`` instances (envs/vector.py);
    done envs are re-initialized inside the same step (SAME_STEP autoreset).
    """

    metadata: Dict[str, Any] = {"autoreset_mode": None}

    def __init__(self, num_envs: int, config: Optional[Dict[str, Any]] = None,
                 seed: int = 0):
        _require_gymnasium()
        config = dict(config or {})
        if int(config.get("num_agents", 1)) != 1:
            raise ValueError("GymnasiumVectorEnv is single-agent-per-env; "
                             "use envs.vector.VectorEnv for multi-agent")
        config["num_agents"] = 1
        core, cfg, routes = _build_core(config)
        pool = core.table.route_ids(routes) if config.get("ego_routes") else None
        self._venv = VectorEnv(core, num_envs=num_envs, route_pool=pool, seed=seed)
        self._state = None

        self.num_envs = num_envs
        self.single_observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=(127,), dtype=np.float32)
        self.single_action_space = spaces.Box(
            low=-1.0, high=1.0, shape=(2,), dtype=np.float32)
        self.observation_space = gymnasium.vector.utils.batch_space(
            self.single_observation_space, num_envs)
        self.action_space = gymnasium.vector.utils.batch_space(
            self.single_action_space, num_envs)
        try:
            from gymnasium.vector import AutoresetMode
            self.metadata = {"autoreset_mode": AutoresetMode.SAME_STEP}
        except ImportError:  # older gymnasium
            pass

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None:
            self._venv.generator.manual_seed(seed)
        self._state, obs = self._venv.reset()
        return obs[:, 0].cpu().numpy(), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        dev = self._venv.env.device
        a = torch.from_numpy(np.asarray(actions, np.float32)
                             .reshape(self.num_envs, 1, 2)).to(dev)
        self._state, out, term_obs = self._venv.step(self._state, a, final_obs=True)
        term = out.terminated.cpu().numpy()
        trunc = out.truncated.cpu().numpy()
        infos = {}
        done = term | trunc
        if done.any():
            # gymnasium SAME_STEP contract: the TERMINAL observation of each
            # finished episode rides in infos (the returned obs is already
            # the fresh post-reset one), object arrays + boolean mask, the
            # layout of gymnasium.vector.SyncVectorEnv._add_info
            fo = np.full(self.num_envs, None, dtype=object)
            fi = np.full(self.num_envs, None, dtype=object)
            t_obs = term_obs[:, 0].cpu().numpy()
            for i in np.nonzero(done)[0]:
                fo[i] = t_obs[i]
                fi[i] = {}
            infos = {"final_obs": fo, "_final_obs": done.copy(),
                     "final_info": fi, "_final_info": done.copy()}
        return (out.obs[:, 0].cpu().numpy(), out.reward[:, 0].cpu().numpy(),
                term, trunc, infos)

    def close_extras(self, **kwargs):
        pass
