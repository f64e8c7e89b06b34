"""Recurrent (GRU) actor-critic, the recurrent model family.

Counterpart of marl_traffic_intersection_tpu/models/recurrent.py: a 256-wide
tanh Dense torso, a 128-wide GRU cell, the ``pi_mean`` and ``vf`` heads and
the shared ``bounded_log_std``. ``forward(obs, h)`` returns ``(mean, log_std,
value, h_new)``; the hidden state is part of the rollout's carry and the
learner zeroes it at agent life boundaries (parallel/recurrent_ppo.py).

The cell is flax 0.12's ``GRUCell`` written out (not ``torch.nn.GRUCell``,
whose ``n`` gate puts the recurrent bias elsewhere)::

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Every product runs in the compute dtype (bf16 by default) with float32
parameters, as flax's ``Dense(dtype=bf16)`` does: the incoming float32 hidden
state is rounded to bf16 first, each gate's products and sums are bf16, and
``h'`` comes back as float32. The three input products are one (3H, in)
matrix and the three recurrent ones one (3H, H) matrix; ``convert.py`` fills
their row blocks from flax's ``ir``/``iz``/``in`` and ``hr``/``hz``/``hn``.
The ``hn`` bias is added to the recurrent product's ``n`` block after that
product is rounded, where flax's ``Dense`` adds it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .actor_critic import _raw_log_std_init, bounded_log_std, dense, init_linear_, lecun_normal_


class GRUCell(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        H = features
        self.w_ih = nn.Parameter(torch.empty(3 * H, in_features))
        self.b_ih = nn.Parameter(torch.zeros(3 * H))
        self.w_hh = nn.Parameter(torch.empty(3 * H, H))
        self.b_hn = nn.Parameter(torch.zeros(H))
        with torch.no_grad():
            for g in range(3):      # flax's defaults, gate by gate
                lecun_normal_(self.w_ih[g * H:(g + 1) * H], in_features)
                nn.init.orthogonal_(self.w_hh[g * H:(g + 1) * H])

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x (..., in), h (..., H), both in the compute dtype -> h' in it."""
        dt = x.dtype
        gi = F.linear(x, self.w_ih.to(dt), self.b_ih.to(dt))
        gh = F.linear(h, self.w_hh.to(dt))
        i_r, i_z, i_n = gi.chunk(3, -1)
        h_r, h_z, h_n = gh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.b_hn.to(dt)))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    def __init__(self, obs_dim: int = 127, hidden: int = 256, gru: int = 128,
                 act_dim: int = 2, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.gru_features = gru
        self.torso_0 = nn.Linear(obs_dim, hidden)
        self.gru = GRUCell(hidden, gru)
        self.pi_mean = nn.Linear(gru, act_dim)
        self.vf = nn.Linear(gru, 1)
        self.log_std = nn.Parameter(torch.full((act_dim,), _raw_log_std_init()))
        for layer, gain in ((self.torso_0, np.sqrt(2)), (self.pi_mean, 0.01), (self.vf, 1.0)):
            init_linear_(layer, gain)

    def forward(self, obs: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., 127), h (..., gru) f32 -> (mean (..., 2) f32, log_std (2,)
        f32, value (...) f32, h_new (..., gru) f32)."""
        cd = self.compute_dtype
        x = torch.tanh(dense(self.torso_0, obs.to(cd), cd))
        y = self.gru(x, h.to(cd))
        mean = dense(self.pi_mean, y, cd).float()
        value = dense(self.vf, y, cd)[..., 0].float()
        return mean, bounded_log_std(self.log_std), value, y.float()

    def initial_hidden(self, *batch_shape, device=None) -> torch.Tensor:
        return torch.zeros((*batch_shape, self.gru_features), dtype=torch.float32,
                           device=device)
