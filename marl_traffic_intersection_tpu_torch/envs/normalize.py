"""Return-based reward normalization wrapper over VectorEnv.

Counterpart of marl_traffic_intersection_tpu/envs/normalize.py. Rewards are
divided by the running standard deviation of the discounted return (Gym's
``NormalizeReward``), which rescales the dense progress terms and the sparse
±10 terminal bonuses alike without recentering. Statistics are kept per env:
every leaf of ``NormState`` has the env axis first. ``count`` is int32, as in
the JAX package; the scale is ``rsqrt(var + eps)``, the identity until
``warmup`` samples, and the normalized reward is clipped to ±``clip``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.constants import DT_DEFAULT
from ..core.env import EnvState
from ..utils.graphs import EAGER
from .vector import VectorEnv


class NormState(NamedTuple):
    env_state: EnvState      # the wrapped env's state (B-leading)
    ret: torch.Tensor        # (B, N) f32 discounted return accumulator
    count: torch.Tensor      # (B,) int32 samples seen per env
    mean: torch.Tensor       # (B,) f32 running mean of returns
    m2: torch.Tensor         # (B,) f32 running sum of squared deviations


class RewardNormVecEnv:
    """Drop-in VectorEnv: the same reset/step surface, normalized
    ``out.reward``; statuses, dones and obs pass through."""

    def __init__(self, venv: VectorEnv, gamma: float = 0.99, clip: float = 10.0,
                 eps: float = 1e-8, warmup: int = 64):
        self.venv = venv
        self.env = venv.env
        self.num_envs = venv.num_envs
        self.gamma = float(gamma)
        self.clip = float(clip)
        self.eps = float(eps)
        self.warmup = int(warmup)

    @property
    def generator(self) -> torch.Generator:
        """The wrapped VectorEnv's route generator."""
        return self.venv.generator

    def with_mesh(self, mesh) -> "RewardNormVecEnv":
        """This wrapper over ``venv.with_mesh(mesh)``; the statistics are per
        env, so each rank keeps its own envs'."""
        return RewardNormVecEnv(self.venv.with_mesh(mesh), self.gamma, self.clip, self.eps,
                                self.warmup)

    def reset(self) -> Tuple[NormState, torch.Tensor]:
        env_state, obs = self.venv.reset()
        b, n, dev = obs.shape[0], self.env.config.num_agents, self.env.device
        f32 = dict(dtype=torch.float32, device=dev)
        return NormState(env_state=env_state, ret=torch.zeros((b, n), **f32),
                         count=torch.zeros((b,), dtype=torch.int32, device=dev),
                         mean=torch.zeros((b,), **f32), m2=torch.zeros((b,), **f32)), obs

    def draws(self, dt: float = DT_DEFAULT) -> tuple:
        """The wrapped VectorEnv's draws of one step (VectorEnv.draws)."""
        return self.venv.draws(dt)

    def step(self, state: NormState, actions: torch.Tensor, dt: float = DT_DEFAULT):
        return self.step_body(state, actions, self.draws(dt), dt)

    def step_body(self, state: NormState, actions: torch.Tensor, draws: tuple,
                  dt: float = DT_DEFAULT, *, run=EAGER, finish=None):
        """``step`` with the step's random draws given (``draws``' result);
        the normalisation reads nothing back to the host, so it runs inside
        the wrapped step's last segment (``VectorEnv.step_body``'s ``run``
        and ``finish``), and graphs with it."""
        def normalized(env_state, out):
            result = self._normalize(state, env_state, out)
            return result if finish is None else finish(*result)
        return self.venv.step_body(state.env_state, actions, draws, dt, run=run,
                                   finish=normalized)

    def _normalize(self, state: NormState, env_state, out):
        reward = out.reward                                    # (B, N)
        n = reward.shape[-1]

        # discounted-return accumulator, cut at per-agent done and at episode ends
        done = out.done | (out.terminated | out.truncated)[:, None]
        ret = self.gamma * state.ret * (1.0 - done.float()) + reward

        # per-env Welford merge of this tick's N return samples
        batch_mean = ret.mean(-1)
        batch_m2 = ((ret - batch_mean[:, None]) ** 2).sum(-1)
        count_new = state.count + n
        cf = count_new.float()
        delta = batch_mean - state.mean
        mean_new = state.mean + delta * n / cf
        m2_new = state.m2 + batch_m2 + delta ** 2 * state.count.float() * n / cf

        var = m2_new / torch.clamp(cf - 1.0, min=1.0)
        scale = torch.rsqrt(var + self.eps)
        # identity until enough samples: early over-estimates of the scale
        # would blow the first updates up
        scale = torch.where(count_new >= self.warmup, scale, 1.0)
        norm_reward = torch.clamp(reward * scale[:, None], -self.clip, self.clip)
        new_state = NormState(env_state=env_state, ret=ret, count=count_new,
                              mean=mean_new, m2=m2_new)
        return new_state, out._replace(reward=norm_reward)
