"""Flagship actor-critic MLP for the 127-d observation, forward pass.

Counterpart of marl_traffic_intersection_tpu/models/actor_critic.py: a
256-256 tanh torso with parameters in float32 and compute in bfloat16, a
2-d Gaussian mean head, a value head, and a state-independent log_std bounded
by a tanh. ``mlp_params_from_flax`` (convert.py) loads the JAX package's
weights. Sampling and the PPO losses belong to the PPO slice.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def bounded_log_std(raw: torch.Tensor, lo: float = -4.0, hi: float = 0.5) -> torch.Tensor:
    """log_std smoothly bounded to [lo, hi]: ``lo + (hi-lo)/2 * (tanh(raw) + 1)``."""
    return lo + 0.5 * (hi - lo) * (torch.tanh(raw) + 1.0)


def _raw_log_std_init(lo: float = -4.0, hi: float = 0.5) -> float:
    """The raw value at which the bounded log_std is 0 (its initial value)."""
    return float(np.arctanh(2.0 * (0.0 - lo) / (hi - lo) - 1.0))


class ActorCriticMLP(nn.Module):
    def __init__(self, obs_dim: int = 127, hidden: Sequence[int] = (256, 256),
                 act_dim: int = 2, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = (obs_dim, *hidden)
        self.torso = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.pi_mean = nn.Linear(dims[-1], act_dim)
        self.vf = nn.Linear(dims[-1], 1)
        self.log_std = nn.Parameter(torch.full((act_dim,), _raw_log_std_init()))
        for layer, gain in [(m, np.sqrt(2)) for m in self.torso] + [(self.pi_mean, 0.01),
                                                                     (self.vf, 1.0)]:
            nn.init.orthogonal_(layer.weight, gain=float(gain))
            nn.init.zeros_(layer.bias)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x, layer.weight.to(cd), layer.bias.to(cd))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., 127) -> (mean (..., 2) f32, log_std (2,) f32, value (...) f32)."""
        x = obs.to(self.compute_dtype)
        for layer in self.torso:
            x = torch.tanh(self._dense(layer, x))
        mean = self._dense(self.pi_mean, x).float()
        value = self._dense(self.vf, x)[..., 0].float()
        return mean, bounded_log_std(self.log_std), value

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic action ``tanh(mean)``, float32 in [-1, 1]."""
        return torch.tanh(self(obs)[0])
