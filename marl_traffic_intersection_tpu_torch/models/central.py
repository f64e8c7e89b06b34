"""Centralized-critic actor-critic (MAPPO-style: centralised training,
decentralised execution).

Counterpart of marl_traffic_intersection_tpu/models/central.py. The actor is
the flagship per-agent MLP (256-256 tanh) on the agent's own observation; the
critic embeds every agent's observation (128, tanh), mean-pools the
embeddings over the agent axis, and reads each agent's value from
[own embedding, pooled embedding] through a 256-wide tanh layer. The agent
axis is ``obs.shape[-2]``, so pooling composes with any leading layout,
such as the learner's (T, B, N, 127). Parameters float32, compute bfloat16.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.constants import OBS_DIM
from .actor_critic import _raw_log_std_init, bounded_log_std, dense, init_linear_


class CentralizedActorCritic(nn.Module):
    """Per-agent actor + permutation-invariant centralized critic; obs must be
    (..., N, obs_dim)."""

    needs_agent_axis = True

    def __init__(self, hidden: Sequence[int] = (256, 256), embed: int = 128, act_dim: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = (OBS_DIM, *hidden)
        self.torso = nn.ModuleList(init_linear_(nn.Linear(a, b), np.sqrt(2))
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.pi_mean = init_linear_(nn.Linear(dims[-1], act_dim), 0.01)
        self.log_std = nn.Parameter(torch.full((act_dim,), _raw_log_std_init()))
        self.critic_embed = init_linear_(nn.Linear(OBS_DIM, embed), np.sqrt(2))
        self.critic_joint = init_linear_(nn.Linear(embed * 2, embed * 2), np.sqrt(2))
        self.vf = init_linear_(nn.Linear(embed * 2, 1), 1.0)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., N, 127) -> (mean (..., N, 2) f32, log_std (2,) f32, value (..., N) f32)."""
        if obs.dim() < 2:
            raise ValueError("CentralizedActorCritic needs (..., N, obs_dim)")
        cd = self.compute_dtype
        x = obs.to(cd)
        a = x
        for layer in self.torso:
            a = torch.tanh(dense(layer, a, cd))
        mean = dense(self.pi_mean, a, cd).float()
        e = torch.tanh(dense(self.critic_embed, x, cd))
        pooled = e.mean(dim=-2, keepdim=True).expand(e.shape)
        c = torch.tanh(dense(self.critic_joint, torch.cat([e, pooled], dim=-1), cd))
        value = dense(self.vf, c, cd)[..., 0].float()
        return mean, bounded_log_std(self.log_std), value
