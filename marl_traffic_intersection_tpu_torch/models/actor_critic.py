"""Flagship actor-critic MLP for the 127-d observation, and the Gaussian policy.

Counterpart of marl_traffic_intersection_tpu/models/actor_critic.py: a
256-256 tanh torso with parameters in float32 and compute in bfloat16, a
2-d Gaussian mean head, a value head, and a state-independent log_std bounded
by a tanh. ``mlp_params_from_flax`` (convert.py) loads the JAX package's
weights. ``sample_action`` and ``logp_and_entropy`` are the tanh-squashed
diagonal Gaussian that every model family shares; the noise of a sample is an
argument, so tests can feed the JAX package's draws (torch cannot replay
jax.random streams).

``dense`` and ``lecun_normal_`` are the flax ``nn.Dense`` conventions the
other families build on: parameters in float32, cast to the compute dtype at
the product; kernels initialised like flax's default (truncated normal,
variance 1/fan_in) unless a family asks for orthogonal ones. ``dense`` also
runs a layer sharded over the mesh's model axis (models/tp.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .tp import copy_in, gather_out, local_in, row_product


# f32 constants, as the JAX package evaluates them: log(2*pi), log(2) and
# 0.5*log(2*pi*e), each the float64 value rounded once to float32
LOG_2PI = float(np.float32(np.log(2.0 * np.pi)))
LOG_2 = float(np.float32(np.log(2.0)))
HALF_LOG_2PIE = float(np.float32(0.5 * np.log(2.0 * np.pi * np.e)))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``: weight and bias cast to it, like flax's
    ``nn.Dense(dtype=..., param_dtype=float32)``. A layer that
    ``parallel/mesh.py::shard_model_`` tagged with a ``tp_role`` runs as
    that tensor-parallel role (models/tp.py)."""
    role = getattr(layer, "tp_role", None)
    if role is None:
        return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
    if role.kind == "row":
        w = layer.weight.to(dtype).float()
        return row_product(local_in(x, role, w.shape[1]), role, lambda x32: F.linear(x32, w),
                           layer.bias, dtype)
    y = F.linear(copy_in(x, role), layer.weight.to(dtype), layer.bias.to(dtype))
    return gather_out(y, role) if role.kind == "gather" else y


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: normal of variance 1/fan_in truncated at
    two standard deviations (rescaled so the truncated variance is 1/fan_in)."""
    std = float(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def init_linear_(layer: nn.Linear, gain=None) -> nn.Linear:
    """Zero bias; an orthogonal weight of ``gain``, or flax's lecun normal
    when ``gain`` is None."""
    if gain is None:
        lecun_normal_(layer.weight, layer.in_features)
    else:
        nn.init.orthogonal_(layer.weight, gain=float(gain))
    nn.init.zeros_(layer.bias)
    return layer


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
            init_linear_(layer, gain)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., 127) -> (mean (..., 2) f32, log_std (2,) f32, value (...) f32)."""
        cd = self.compute_dtype
        x = obs.to(cd)
        for layer in self.torso:
            x = torch.tanh(dense(layer, x, cd))
        mean = dense(self.pi_mean, x, cd).float()
        value = dense(self.vf, x, cd)[..., 0].float()
        return mean, bounded_log_std(self.log_std), value

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic action ``tanh(mean)``, float32 in [-1, 1]."""
        return torch.tanh(self(obs)[0])


def draw_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` from ``generator``, on the
    generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device)


def sample_action(mean: torch.Tensor, log_std: torch.Tensor, noise: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-tanh Gaussian sample ``raw = mean + exp(log_std) * noise``;
    returns ``(tanh(raw), raw)``, the action in [-1, 1] and the sample."""
    raw = mean + torch.exp(log_std) * noise
    return torch.tanh(raw), raw


def logp_and_entropy(mean: torch.Tensor, log_std: torch.Tensor, raw_action: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-prob of the tanh-squashed diagonal Gaussian at the pre-tanh
    ``raw_action`` (summed over the action dims), and the base Gaussian's
    entropy broadcast to the log-prob's shape.

    The tanh correction is ``log(1 - tanh(u)^2) = 2 (log 2 - u - softplus(-2u))``
    with ``softplus(x) = max(x, 0) + log1p(exp(-|x|))`` (``torch.logaddexp``,
    the form of ``jax.nn.softplus``): ``F.softplus`` returns ``x`` itself above
    its threshold.
    """
    std = torch.exp(log_std)
    var = std * std
    logp = -0.5 * (((raw_action - mean) ** 2) / var + 2.0 * log_std + LOG_2PI).sum(-1)
    m2u = -2.0 * raw_action
    softplus = torch.logaddexp(m2u, torch.zeros_like(m2u))
    logp = logp - (2.0 * (LOG_2 - raw_action - softplus)).sum(-1)
    entropy = (log_std + HALF_LOG_2PIE).sum(-1)
    return logp, entropy.expand(logp.shape)
