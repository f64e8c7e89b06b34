"""Tensor-parallel forward: the collectives a layer sharded over the mesh's
``model`` axis needs, and the layer roles that place them.

The JAX package shards parameters with ``NamedSharding`` and lets XLA insert
the collectives; here the models call them where the sharded contraction
is. ``parallel/mesh.py::shard_model_`` narrows the parameters in place and
tags each sharded layer with a ``Role``; the models' forwards (through
``actor_critic.dense`` and the attention, GRU and twin-Q forwards) read the
tag. A layer without a tag runs as before.

Roles (Megatron-LM's, in ``nn.Linear``'s (out, in) layout):

  * ``column``: the weight's output rows (and the bias) are split; the
    input is whole on every rank and the output is the rank's slice of the
    features.
  * ``gather``: ``column``, then the output slices are all-gathered into
    the whole features (for a sharded layer whose consumer is replicated:
    conv's ``fuse``, the GRU's ``torso_0``). Bit-equal to the unsharded
    layer: no sum changes order.
  * ``row``: the weight's input columns are split and the bias is whole.
    The rank multiplies its slice of the input features (cut from a whole
    input when it gets one) and the partial products are all-reduced in
    float32, then the bias is added once and the sum cast to the compute
    dtype once.

The autograd rules are Megatron's: the loss is the same on every model rank,
so the all-reduce of ``row`` passes the gradient through unchanged, the
whole input of a ``column`` layer all-reduces its gradient backwards (each
rank holds only its shard's part of it), a ``gather`` keeps the rank's slice
of its gradient, and a whole input that a ``row`` layer cuts all-gathers the
slices' gradients. ``torch.distributed.nn.functional``'s
``all_reduce`` is not used for this: its backward sums the gradient over the
group, which counts a replicated loss once per rank. Every collective runs
in float32 and casts back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class Role(NamedTuple):
    kind: str             # "column" | "gather" | "row"
    group: object         # the model axis' process group
    size: int             # ranks on the model axis
    rank: int             # this rank's index on it


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` in float32, in a new tensor of x's dtype."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, role: Role) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dim, in rank order."""
    parts = [torch.empty_like(x, dtype=torch.float32) for _ in range(role.size)]
    dist.all_gather(parts, x.float().contiguous(), group=role.group)
    return torch.cat(parts, -1).to(x.dtype)


def _local(x: torch.Tensor, role: Role) -> torch.Tensor:
    k = x.shape[-1] // role.size
    return x[..., role.rank * k:(role.rank + 1) * k]


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: the whole input of a column layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a row layer."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward, the rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, role):
        ctx.role = role
        return _all_gather(x, role)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.role).contiguous(), None


class _Scatter(torch.autograd.Function):
    """The rank's slice of a whole input forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, role):
        ctx.role = role
        return _local(x, role).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.role), None


def copy_in(x: torch.Tensor, role: Role) -> torch.Tensor:
    return _Copy.apply(x, role.group)


def reduce_out(x: torch.Tensor, role: Role) -> torch.Tensor:
    return _Reduce.apply(x, role.group)


def gather_out(x: torch.Tensor, role: Role) -> torch.Tensor:
    return _Gather.apply(x, role)


def local_in(x: torch.Tensor, role: Role, width: int) -> torch.Tensor:
    """``x`` cut to the rank's ``width`` input features, unless already cut."""
    if x.shape[-1] == width:
        return x
    return _Scatter.apply(x, role)


def row_product(x: torch.Tensor, role: Role, product, bias, dtype) -> torch.Tensor:
    """A row layer: ``product(x32)`` is the float32 partial of the rank's
    input slice ``x32``; the partials all-reduced, then ``bias`` added and
    the result cast to ``dtype``, once each."""
    y = reduce_out(product(x.float()), role)
    if bias is not None:
        y = y + bias.to(dtype).float()
    return y.to(dtype)
