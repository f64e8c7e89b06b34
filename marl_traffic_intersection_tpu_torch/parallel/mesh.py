"""Device mesh over torch.distributed, the env batch's data sharding and the
tensor-parallel rules.

Counterpart of marl_traffic_intersection_tpu/parallel/mesh.py. The JAX
package drives every local device from one process and lets XLA partition
one program over a ``(data, model)`` mesh; here there is one process per
card (``torchrun``), and the mesh is a ``torch.distributed.DeviceMesh``
with the same axes over the process group:

  * ``data``: the env batch is split into equal contiguous shards, one per
    data rank (``data_slice``). Stepping envs needs no communication; the
    learners reduce over this axis (gradients, advantage statistics, logged
    metrics).
  * ``model``: each family's parameters are split by the JAX package's rules
    (``param_shardings``); ``shard_model_`` narrows them in place and tags
    the layers whose forward then calls the collectives (models/tp.py).

``make_hybrid_mesh`` adds the ``replica`` axis of a multi-node run in front
(one entry per node, ``WORLD_SIZE // LOCAL_WORLD_SIZE``); the env batch is
then split over ``replica`` and ``data`` together.

JAX's kernels are (in, out) and ``nn.Linear``'s weights (out, in), so JAX's
column split (of the kernel's dim 1) is a split of the weight's dim 0 here;
the twin critic keeps flax's (2, in, out) layout and its dims. A rule's split
is dropped, the parameter replicated, when the model axis does not divide the
split dimension (for attention's projections: the number of heads), as in
the JAX package.
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.tp import Role

JOINT_DATA = "replica_data"     # the flattened (replica, data) axis of a hybrid mesh


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_from_torchrun(device=None) -> torch.device:
    """Join the process group torchrun describes in the environment and
    return this rank's device: with ``device="cpu"`` the CPU and gloo, else
    the card ``cuda:LOCAL_RANK`` and NCCL. Raises without torchrun's
    environment, and without a card unless the CPU was asked for."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment ({', '.join(missing)} "
                           "unset): run under torchrun --nproc_per_node N -m ...")
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if device is not None:
            raise ValueError(f"device {device!r}: a rank's card is cuda:LOCAL_RANK; "
                             "pass nothing or 'cpu'")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
        dev, backend = torch.device("cuda", int(os.environ["LOCAL_RANK"])), "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the whole process group (rank =
    data index * n_model + model index)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(_device_type(), (n_data, n_model), mesh_dim_names=("data", "model"))


def make_hybrid_mesh(n_model: int = 1) -> DeviceMesh:
    """A ``(replica, data, model)`` mesh: ``replica`` spans the nodes
    (``WORLD_SIZE // LOCAL_WORLD_SIZE``, torchrun's variables; 1 on one
    node), ``data`` and ``model`` the ranks of a node."""
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_node or per_node % n_model:
        raise ValueError(f"{world} ranks, {per_node} a node, model axis {n_model}: "
                         "the axes do not divide")
    mesh = init_device_mesh(_device_type(), (world // per_node, per_node // n_model, n_model),
                            mesh_dim_names=("replica", "data", "model"))
    mesh["replica", "data"]._flatten(JOINT_DATA)
    return mesh


class Axis(NamedTuple):
    """A mesh axis as the hot paths use it: its process group, its size and
    this rank's index on it. Slicing a DeviceMesh builds a new mesh object
    each time, too slow for a per-step path, so the learners take their
    axes once, when they bind to a mesh."""
    group: object
    size: int
    rank: int


def _axis(sub: DeviceMesh) -> Axis:
    return Axis(sub.get_group(), sub.size(), sub.get_local_rank())


def data_axis(mesh: DeviceMesh) -> Axis:
    """The axis the env batch is split over: ``data``, or ``replica`` and
    ``data`` together on a hybrid mesh."""
    return _axis(mesh[JOINT_DATA] if "replica" in mesh.mesh_dim_names else mesh["data"])


def model_axis(mesh: DeviceMesh) -> Axis:
    return _axis(mesh["model"])


def data_slice(data: Axis, n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    if n % data.size:
        raise ValueError(f"a batch of {n} does not split over {data.size} data shards")
    k = n // data.size
    return slice(data.rank * k, (data.rank + 1) * k)


def global_rows(data: Axis, draw: Callable, shape: Sequence[int]) -> torch.Tensor:
    """This rank's rows of ``draw((rows * data.size, *rest))``: a random
    draw for the global batch, made alike on every rank from the same
    generator, cut to the local ``shape = (rows, *rest)``."""
    n = shape[0] * data.size
    return draw((n, *shape[1:]))[data_slice(data, n)]


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of nested NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch_tree(mesh: DeviceMesh, tree):
    """This rank's rows (dim 0) of every tensor of a global batch's tree."""
    data = data_axis(mesh)
    return tree_map(lambda x: x[data_slice(data, x.shape[0])], tree)


def _gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (bools
    travel as bytes, which every backend carries); ``x`` itself on an axis
    of one rank."""
    if axis.size == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src.contiguous(), group=axis.group)
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def gather_batch_tree(mesh: DeviceMesh, tree):
    """The inverse of ``shard_batch_tree``: every tensor's rows gathered
    from the data ranks, on every rank."""
    data = data_axis(mesh)
    return tree_map(lambda x: _gather(x, data, 0), tree)


def axis_sum_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over the axis' ranks, in place; no collective on an axis
    of one rank (XLA drops a psum over a size-1 axis, too)."""
    if axis.size > 1:
        dist.all_reduce(x, group=axis.group)
    return x


def axis_mean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` (in float32) over the axis' ranks, on every rank;
    ``x`` in float32 on an axis of one rank."""
    if axis.size == 1:
        return x.float()
    return axis_sum_(x.float().clone(), axis) / axis.size


# ------------------------------------------------------------------ tensor
# Each rule maps a parameter's name in the port's module (and its shape) to
# the dim it splits, or None: the JAX package's rule of the same name, with
# flax's (in, out) kernels read as nn.Linear's (out, in) weights.

def _mlp_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """ActorCriticMLP: the first torso layer column-split (weight rows and
    bias), the second row-split (weight columns; bias whole, added once);
    heads replicated."""
    if name.startswith("torso.0."):
        return 0
    if name == "torso.1.weight":
        return 1
    return None


_BLOCK = re.compile(r"blocks\.\d+\.(attn\.query|attn\.key|attn\.value|attn\.out|dense_0|dense_1)"
                    r"\.(weight|bias)$")


def _transformer_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """SceneTransformerPolicy blocks, Megatron's layout: query/key/value and
    the MLP's up projection column-split (on heads for the projections),
    attention-out and the MLP's down projection row-split."""
    m = _BLOCK.match(name)
    if not m:
        return None
    if m.group(1) in ("attn.out", "dense_1"):
        return 1 if m.group(2) == "weight" else None
    return 0


def _conv_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """LidarConvPolicy: the wide ``fuse`` layer column-split; the ray convs
    replicated. The heads contract over fuse's features, which are gathered
    first."""
    return 0 if name.startswith("fuse.") else None


def _gru_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """RecurrentActorCritic: the input torso column-split and gathered before
    the cell; the GRU cell and heads replicated (the carry stays whole)."""
    return 0 if name.startswith("torso_0.") else None


def _central_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """CentralizedActorCritic: the actor torso as the MLP family; the
    critic replicated, so the mean over agents never crosses ranks."""
    return _mlp_rule(name, shape)


def _sac_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """SquashedGaussianActor: the MLP family's split of its torso."""
    return _mlp_rule(name, shape)


def _sac_q_rule(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """TwinQCritic, (2, in, out) kernels: torso_0's output features split
    (kernel dim 2, bias dim 1), torso_1's and the scalar head's input
    features (kernel dim 1, biases whole); the twin axis whole."""
    if name == "kernels.0":
        return 2
    if name == "biases.0":
        return 1
    if name == "kernels.1" or (name.startswith("kernels.") and shape[-1] == 1):
        return 1
    return None


_RULES = {"mlp": _mlp_rule, "attention": _transformer_rule, "conv": _conv_rule,
          "gru": _gru_rule, "central": _central_rule, "sac": _sac_rule, "sac_q": _sac_q_rule}
# column layers whose output is gathered whole for a replicated consumer
_GATHERED = {"conv": ("fuse",), "gru": ("torso_0",)}


def _units(model: nn.Module, name: str, shape, dim: int) -> int:
    """How many indivisible units the split dim holds: heads for attention's
    projections, else its elements."""
    if ".attn." in name:
        return shape[dim] // model.get_submodule(name.rsplit(".", 2)[0]).head_dim
    return shape[dim]


def param_shardings(model: nn.Module, model_kind: str, n_model: int) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over the model axis, or None}."""
    rule = _RULES[model_kind]
    out = {}
    for name, p in model.named_parameters():
        dim = rule(name, tuple(p.shape)) if n_model > 1 else None
        if dim is not None and _units(model, name, p.shape, dim) % n_model:
            dim = None
        out[name] = dim
    return out


def _narrow(t: torch.Tensor, dim: int, role: Role) -> torch.Tensor:
    k = t.shape[dim] // role.size
    return t.narrow(dim, role.rank * k, k).clone()


def shard_model_(model: nn.Module, model_kind: str, mesh: DeviceMesh,
                 optimizers: Iterable[torch.optim.Optimizer] = ()) -> Dict[str, Optional[int]]:
    """Split ``model``'s parameters over the mesh's model axis in place, by
    ``param_shardings``: each split parameter keeps its object and holds the
    rank's slice (with Adam's moments in ``optimizers``, if any), and records
    its dim as ``tp_dim``; the layers get their models/tp.py roles. A model
    already split is left as it is. Returns the dims."""
    role = Role("column", *model_axis(mesh))
    dims = param_shardings(model, model_kind, role.size)
    if getattr(model, "tp_sharded", False) or not any(d is not None for d in dims.values()):
        return dims
    states = {}
    for opt in optimizers:
        states.update(opt.state)
    params = dict(model.named_parameters())
    for name, dim in dims.items():
        if dim is None:
            continue
        p = params[name]
        st = states.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                st[k] = _narrow(st[k], dim, role)
        p.data = _narrow(p.data, dim, role)
        p.tp_dim = dim
    if model_kind == "sac_q":
        model.tp_roles = [None if dims[f"kernels.{i}"] is None else
                          role._replace(kind="column" if dims[f"kernels.{i}"] == 2 else "row")
                          for i in range(len(model.kernels))]
    else:
        for lname, layer in model.named_modules():
            if isinstance(layer, nn.Linear) and dims.get(f"{lname}.weight") is not None:
                kind = "row" if dims[f"{lname}.weight"] == 1 else \
                    "gather" if lname in _GATHERED.get(model_kind, ()) else "column"
                layer.tp_role = role._replace(kind=kind)
    model.tp_sharded = True
    return dims


def full_tensor(t: torch.Tensor, dim: Optional[int], mesh: DeviceMesh) -> torch.Tensor:
    """A split parameter (or moment) gathered whole over the model axis."""
    if dim is None:
        return t
    return _gather(t, model_axis(mesh), dim)


def full_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: DeviceMesh
                     ) -> Tuple[dict, dict]:
    """The model's and Adam's state dicts with every split tensor gathered
    whole: the single-process format, on every rank."""
    dims = {name: getattr(p, "tp_dim", None) for name, p in model.named_parameters()}
    model_sd = {k: full_tensor(v, dims.get(k), mesh) for k, v in model.state_dict().items()}
    opt_sd = optimizer.state_dict()
    index = {i: getattr(p, "tp_dim", None)
             for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    opt_sd["state"] = {i: {k: (full_tensor(v, index[i], mesh) if k != "step" else v)
                           for k, v in st.items()} for i, st in opt_sd["state"].items()}
    return model_sd, opt_sd


def global_grad_norm(params: Sequence[torch.Tensor], model: Axis) -> torch.Tensor:
    """The global norm of the parameters' gradients: the squares of split
    parameters' shards summed over the model axis, replicated ones counted
    once."""
    zero = torch.zeros((), device=params[0].grad.device)
    whole = sum(((p.grad * p.grad).sum() for p in params
                 if getattr(p, "tp_dim", None) is None), zero)
    split = sum(((p.grad * p.grad).sum() for p in params
                 if getattr(p, "tp_dim", None) is not None), zero)
    return torch.sqrt(whole + axis_sum_(split, model))


def average_gradients_(params: Sequence[torch.Tensor], data: Axis) -> None:
    """Every gradient averaged over the data ranks in place, in one
    all-reduce of their concatenation (shards are equal in size, so the mean
    of the ranks' means is the global batch's mean)."""
    if data.size == 1:
        return
    grads = [p.grad for p in params]
    flat = axis_sum_(torch.cat([g.reshape(-1) for g in grads]), data) / data.size
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
