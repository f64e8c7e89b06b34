"""SAC networks: the squashed-Gaussian actor and the twin Q critic.

Counterpart of marl_traffic_intersection_tpu/models/sac.py. Like the PPO
families they compute in bfloat16 with float32 parameters and outputs.

  * ``SquashedGaussianActor``: a 256-256 relu torso, then ``mean`` and a
    state-dependent ``log_std`` head, the latter clipped to [-5, 2] in float32.
  * ``sample_squashed(mean, log_std, noise)``: the reparameterised tanh-Gaussian
    sample and its log-prob, the tanh correction in the softplus form of the
    JAX package (softplus as ``logaddexp(x, 0)``, ``jax.nn.softplus``'s form).
    The noise is an argument, so tests can feed the JAX package's draws.
  * ``TwinQCritic``: the JAX package's two ``QCritic`` parameter sets stacked
    on a leading axis of 2 and applied under ``vmap`` (parallel/sac.py). Here
    each layer's weight is held as that stack, (2, in, out) in flax's layout,
    and applied to both critics at once with ``torch.baddbmm``. Sharded over
    the mesh's model axis, the first layer splits its output features and the
    later ones their input features, the twin axis whole (models/tp.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .actor_critic import LOG_2, LOG_2PI, dense, init_linear_
from .tp import copy_in, local_in, row_product

LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0


class SquashedGaussianActor(nn.Module):
    def __init__(self, obs_dim: int = 127, hidden: Sequence[int] = (256, 256),
                 act_dim: int = 2, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.act_dim = act_dim
        dims = (obs_dim, *hidden)
        self.torso = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.mean = nn.Linear(dims[-1], act_dim)
        self.log_std = nn.Linear(dims[-1], act_dim)
        for layer, gain in [(m, np.sqrt(2)) for m in self.torso] + [(self.mean, 0.01),
                                                                     (self.log_std, 0.01)]:
            init_linear_(layer, gain)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (..., 127) -> (mean (..., 2) f32, log_std (..., 2) f32 in [-5, 2])."""
        cd = self.compute_dtype
        x = obs.to(cd)
        for layer in self.torso:
            x = torch.relu(dense(layer, x, cd))
        mean = dense(self.mean, x, cd).float()
        log_std = dense(self.log_std, x, cd).float().clamp(LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std


def sample_squashed(mean: torch.Tensor, log_std: torch.Tensor, noise: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raw = mean + exp(log_std) * noise``; returns ``(tanh(raw), logp)``,
    the action in [-1, 1] and its log-prob summed over the action dims."""
    std = torch.exp(log_std)
    raw = mean + std * noise
    logp = -0.5 * (((raw - mean) / std) ** 2 + 2.0 * log_std + LOG_2PI).sum(-1)
    m2u = -2.0 * raw
    softplus = torch.logaddexp(m2u, torch.zeros_like(m2u))
    logp = logp - (2.0 * (LOG_2 - raw - softplus)).sum(-1)
    return torch.tanh(raw), logp


class TwinQCritic(nn.Module):
    """Q(s, a) of two critics at once: (..., 127), (..., 2) -> (2, ...)."""

    def __init__(self, obs_dim: int = 127, act_dim: int = 2, hidden: Sequence[int] = (256, 256),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = (obs_dim + act_dim, *hidden, 1)
        self.kernels = nn.ParameterList(nn.Parameter(torch.empty(2, a, b))
                                        for a, b in zip(dims[:-1], dims[1:]))
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros(2, b)) for b in dims[1:])
        gains = [np.sqrt(2)] * len(hidden) + [1.0]
        with torch.no_grad():
            for w, gain in zip(self.kernels, gains):
                for twin in w:     # (in, out): orthogonal as flax draws it
                    nn.init.orthogonal_(twin.T, gain=float(gain))
        # each layer's models/tp.py role when sharded over the model axis
        self.tp_roles = None

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        lead = obs.shape[:-1]
        x = torch.cat([obs, action], -1).to(cd).reshape(1, -1, obs.shape[-1] + action.shape[-1])
        x = x.expand(2, -1, -1)
        last = len(self.kernels) - 1
        for i, (w, b) in enumerate(zip(self.kernels, self.biases)):
            role = self.tp_roles[i] if self.tp_roles else None
            if role is None:
                x = torch.baddbmm(b.to(cd)[:, None, :], x, w.to(cd))
            elif role.kind == "column":
                x = torch.baddbmm(b.to(cd)[:, None, :], copy_in(x, role), w.to(cd))
            else:
                wf = w.to(cd).float()
                x = row_product(local_in(x, role, wf.shape[1]), role,
                                lambda x32: torch.bmm(x32, wf), b[:, None, :], cd)
            if i < last:
                x = torch.relu(x)
        return x[..., 0].float().reshape(2, *lead)
