"""Structured scene-attention policy: the 127-d obs as 14 entity tokens.

Counterpart of marl_traffic_intersection_tpu/models/attention.py:

  token 0:      ego + target features (6)
  tokens 1-5:   neighbour slots (5 features each), key-padding-masked when
                the slot is all zero (absent neighbour)
  tokens 6-13:  lidar, 96 rays folded into 8 sector tokens of 12 rays

then ``depth`` pre-LN transformer blocks, a final LayerNorm and the ego
token's readout into the Gaussian mean and the value. Parameters float32,
compute bfloat16.

It follows flax's modules where they differ from PyTorch's defaults:
LayerNorm epsilon 1e-6 with its statistics in float32; ``nn.gelu``'s tanh
approximation; ``MultiHeadDotProductAttention`` with the query scaled by
1/sqrt(head_dim) before the product, masked scores set to the dtype's most
negative value, and the softmax in the compute dtype, written out rather
than fused, so the comparison with flax stays plain. The projections keep
flax's shapes: ``query``/``key``/``value`` kernels (D, H, Dh) and ``out``
(H, Dh, D), stored here as ``nn.Linear`` weights (H*Dh, D) and (D, H*Dh).
Sharded over the mesh's model axis, a rank holds whole heads: the
projections' head-major rows and ``out``'s columns (models/tp.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.constants import LIDAR_RAYS, NEIGHBOR_COUNT, OBS_DIM
from ..ops import libm
from .actor_critic import _raw_log_std_init, bounded_log_std, dense, init_linear_

_EGO_F = 6
_NEI_F = 5
_SECTORS = 8
_TOKENS = 1 + NEIGHBOR_COUNT + _SECTORS
LN_EPS = 1e-6


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=x.dtype)``: statistics, scale and shift in
    float32, the result in ``x``'s dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS).to(x.dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.query, self.key, self.value = (init_linear_(nn.Linear(dim, dim)) for _ in range(3))
        self.out = init_linear_(nn.Linear(dim, dim))

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """x (B, T, D) in the compute dtype; keep (B, T) bool, False = masked key."""
        cd = x.dtype
        b, t, d = x.shape
        dh = self.head_dim
        # the heads this rank holds: all of them unless the projections
        # are sharded over the model axis (column split on heads)
        h = self.query.weight.shape[0] // dh
        q, k, v = (dense(p, x, cd).reshape(b, t, h, dh) for p in (self.query, self.key, self.value))
        # flax divides by sqrt(head_dim) rounded to the compute dtype; the
        # divisor is a device-resident 0-d tensor (ops/libm.div)
        q = q / libm.const(float(torch.tensor(np.sqrt(dh)).to(cd)), x.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = torch.where(keep[:, None, None, :], s, torch.finfo(cd).min)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, h * dh)
        return dense(self.out, o, cd)


class Block(nn.Module):
    """Pre-LN transformer block (``_Block`` of the JAX package)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ln_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dense_0 = init_linear_(nn.Linear(dim, dim * 4))
        self.dense_1 = init_linear_(nn.Linear(dim * 4, dim))

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        cd = x.dtype
        x = x + self.attn(layer_norm(self.ln_0, x), keep)
        h = F.gelu(dense(self.dense_0, layer_norm(self.ln_1, x), cd), approximate="tanh")
        return x + dense(self.dense_1, h, cd)


class SceneTransformerPolicy(nn.Module):
    def __init__(self, dim: int = 128, heads: int = 4, depth: int = 2, act_dim: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed_ego = init_linear_(nn.Linear(_EGO_F, dim))
        self.embed_neighbor = init_linear_(nn.Linear(_NEI_F, dim))
        self.embed_lidar = init_linear_(nn.Linear(LIDAR_RAYS // _SECTORS, dim))
        self.pos = nn.Parameter(torch.randn(1, _TOKENS, dim) * 0.02)
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=LN_EPS)
        self.pi_mean = init_linear_(nn.Linear(dim, act_dim), 0.01)
        self.vf = init_linear_(nn.Linear(dim, 1))
        self.log_std = nn.Parameter(torch.full((act_dim,), _raw_log_std_init()))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., 127) -> (mean (..., 2) f32, log_std (2,) f32, value (...) f32)."""
        cd = self.compute_dtype
        batch = obs.shape[:-1]
        x = obs.reshape(-1, OBS_DIM).to(cd)
        b = x.shape[0]
        n_end = _EGO_F + NEIGHBOR_COUNT * _NEI_F
        nei = x[:, _EGO_F:n_end].reshape(b, NEIGHBOR_COUNT, _NEI_F)
        lid = x[:, n_end:].reshape(b, _SECTORS, LIDAR_RAYS // _SECTORS)
        tokens = torch.cat([dense(self.embed_ego, x[:, :_EGO_F], cd)[:, None],
                            dense(self.embed_neighbor, nei, cd),
                            dense(self.embed_lidar, lid, cd)], dim=1)   # (B, 14, D)
        tokens = tokens + self.pos.to(cd)
        ones = torch.ones((b, 1), dtype=torch.bool, device=x.device)
        keep = torch.cat([ones, (nei != 0).any(-1), ones.expand(b, _SECTORS)], dim=1)
        h = tokens
        for blk in self.blocks:
            h = blk(h, keep)
        pooled = layer_norm(self.ln_f, h)[:, 0]                       # ego token readout
        mean = dense(self.pi_mean, pooled, cd).float().reshape(*batch, -1)
        value = dense(self.vf, pooled, cd)[..., 0].float().reshape(batch)
        return mean, bounded_log_std(self.log_std), value
