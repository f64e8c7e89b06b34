"""Circular-convolution lidar encoder policy.

Counterpart of marl_traffic_intersection_tpu/models/conv.py. The 96 lidar
rays form a closed ring, so the rays go through two circular 1-D
convolutions (kernel 5, stride 2, channels 32 and 64, ReLU); the 31 non-lidar
features through a 64-wide tanh projection; both are fused by a 256-wide tanh
layer into the Gaussian mean and the value. Parameters float32, compute
bfloat16.

Layout: flax convolves NWC with ``padding="CIRCULAR"``, which wraps
``((k-1)//2, k//2)`` = (2, 2) positions around the ring and then runs a VALID
convolution; ``F.pad(mode="circular")`` + ``F.conv1d`` is the same on NCW.
The flatten before ``fuse`` is position-major and channel-minor, as flax's
(B, 24, 64) -> (B, 1536), so the NCW output is permuted before it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.constants import LIDAR_RAYS, NEIGHBOR_COUNT, OBS_DIM
from .actor_critic import _raw_log_std_init, bounded_log_std, dense, init_linear_, lecun_normal_

_EGO_F = 6
_NEI_F = 5
_STATE_F = _EGO_F + NEIGHBOR_COUNT * _NEI_F   # 31 non-lidar features


class LidarConvPolicy(nn.Module):
    def __init__(self, channels: Sequence[int] = (32, 64), kernel: int = 5, stride: int = 2,
                 hidden: int = 256, act_dim: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel, self.stride = kernel, stride
        self.ray_conv = nn.ModuleList()
        c_in, width = 1, LIDAR_RAYS
        for ch in channels:
            conv = nn.Conv1d(c_in, ch, kernel, stride=stride)
            lecun_normal_(conv.weight, c_in * kernel)
            nn.init.zeros_(conv.bias)
            self.ray_conv.append(conv)
            c_in = ch
            width = (width - 1) // stride + 1                    # padded by k - 1
        self.state_proj = init_linear_(nn.Linear(_STATE_F, 64), np.sqrt(2))
        self.fuse = init_linear_(nn.Linear(width * c_in + 64, hidden), np.sqrt(2))
        self.pi_mean = init_linear_(nn.Linear(hidden, act_dim), 0.01)
        self.vf = init_linear_(nn.Linear(hidden, 1), 1.0)
        self.log_std = nn.Parameter(torch.full((act_dim,), _raw_log_std_init()))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., 127) -> (mean (..., 2) f32, log_std (2,) f32, value (...) f32)."""
        cd = self.compute_dtype
        batch = obs.shape[:-1]
        x = obs.reshape(-1, OBS_DIM).to(cd)
        b = x.shape[0]
        h = x[:, None, _STATE_F:]                                # (B, 1, 96), NCW
        k = self.kernel
        for conv in self.ray_conv:
            h = F.pad(h, ((k - 1) // 2, k // 2), mode="circular")
            h = torch.relu(F.conv1d(h, conv.weight.to(cd), conv.bias.to(cd), stride=self.stride))
        lid_feat = h.permute(0, 2, 1).reshape(b, -1)             # (B, 24 * 64), NWC order
        y = torch.tanh(dense(self.state_proj, x[:, :_STATE_F], cd))
        h = torch.tanh(dense(self.fuse, torch.cat([lid_feat, y], dim=-1), cd))
        mean = dense(self.pi_mean, h, cd).float().reshape(*batch, -1)
        value = dense(self.vf, h, cd)[..., 0].float().reshape(batch)
        return mean, bounded_log_std(self.log_std), value
