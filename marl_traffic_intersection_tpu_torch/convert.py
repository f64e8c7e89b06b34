"""Carry weights and env state between the JAX package and the port.

Both directions go through numpy, so the port imports nothing of JAX:

  * ``mlp_params_from_flax`` loads a flax ``ActorCriticMLP`` parameter tree
    (``torso_0/kernel``, ..., ``pi_mean``, ``vf``, ``log_std``), given as
    nested dicts of numpy arrays, into the port's module. Flax kernels are
    (in, out); ``nn.Linear`` weights are (out, in).
  * ``conv_params_from_flax``, ``attention_params_from_flax`` and
    ``central_params_from_flax`` do the same for the other families;
    ``params_from_flax(kind, ...)`` picks one by family name. Conv kernels
    go from flax's (k, in, out) to (out, in, k); attention's query/key/value
    kernels from (D, H, Dh) to (H*Dh, D) and its ``out`` kernel from
    (H, Dh, D) to (D, H*Dh). Every converter raises ``ValueError`` on a
    shape that does not fit the module.
  * ``gru_params_from_flax`` fills the GRU cell's fused (3H, in) and (3H, H)
    matrices row block by row block from flax's ``ir``/``iz``/``in`` and
    ``hr``/``hz``/``hn``; ``sac_actor_params_from_flax`` loads the SAC actor
    (``params_from_flax("sac", ...)``) and ``sac_critic_params_from_flax`` the
    stacked twin critic, whose (2, in, out) kernels keep flax's layout.
  * ``env_state_from_numpy`` / ``env_state_to_numpy`` convert an ``EnvState``
    given as the JAX package's leaves (``ego``'s fields, ``lidar``,
    ``step_count`` and ``npc``'s fields) so that a lockstep can start from a
    JAX state.
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .core.env import EgoState, EnvState
from .core.npc import NpcState
from .models import make_model
from .models.actor_critic import ActorCriticMLP
from .models.attention import SceneTransformerPolicy
from .models.central import CentralizedActorCritic
from .models.conv import LidarConvPolicy
from .models.recurrent import RecurrentActorCritic
from .models.sac import SquashedGaussianActor, TwinQCritic

# (flax path, the port's parameter, how a flax array becomes its value)
_Entry = Tuple[str, torch.nn.Parameter, Callable[[np.ndarray], np.ndarray]]


def _same(a):
    return a


def _transposed(a):
    return a.T


def _dense(name: str, lin: torch.nn.Linear) -> list:
    """A flax Dense's kernel (in, out) and bias as an nn.Linear's."""
    return [(f"{name}/kernel", lin.weight, _transposed), (f"{name}/bias", lin.bias, _same)]


def _load(params: Mapping, entries: Iterable[_Entry], model: torch.nn.Module) -> torch.nn.Module:
    """Copy each flax leaf into its parameter; raise ValueError on a missing
    leaf or a shape that does not fit."""
    p = params.get("params", params)
    with torch.no_grad():
        for path, param, convert in entries:
            leaf = p
            for k in path.split("/"):
                if k not in leaf:
                    raise ValueError(f"{path}: not in the flax tree")
                leaf = leaf[k]
            value = np.array(convert(np.asarray(leaf, np.float32)), order="C")
            if value.shape != tuple(param.shape):
                raise ValueError(f"{path}: flax {np.shape(leaf)} gives {value.shape}, "
                                 f"the module holds {tuple(param.shape)}")
            param.copy_(torch.from_numpy(value))
    return model


def mlp_params_from_flax(params: Mapping, model: Optional[ActorCriticMLP] = None
                         ) -> ActorCriticMLP:
    """Copy a flax ActorCriticMLP tree (optionally wrapped in ``{"params": ...}``)
    into ``model`` in place and return it; without ``model``, into a new
    bf16-compute module whose widths are read from the tree."""
    p = params.get("params", params)
    if model is None:
        hidden, i = [], 0
        while f"torso_{i}" in p:
            hidden.append(np.shape(p[f"torso_{i}"]["kernel"])[1])
            i += 1
        model = ActorCriticMLP(obs_dim=np.shape(p["torso_0"]["kernel"])[0], hidden=hidden,
                               act_dim=np.shape(p["pi_mean"]["kernel"])[1])
    return _load(params, _mlp_entries(model), model)


def _mlp_entries(model: ActorCriticMLP) -> list:
    entries = []
    for i, lin in enumerate(model.torso):
        entries += _dense(f"torso_{i}", lin)
    entries += _dense("pi_mean", model.pi_mean) + _dense("vf", model.vf)
    entries.append(("log_std", model.log_std, _same))
    return entries


def conv_params_from_flax(params: Mapping, model: Optional[LidarConvPolicy] = None
                          ) -> LidarConvPolicy:
    """A flax LidarConvPolicy tree into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else LidarConvPolicy()
    return _load(params, _conv_entries(model), model)


def _conv_entries(model: LidarConvPolicy) -> list:
    entries = []
    for i, conv in enumerate(model.ray_conv):
        entries += [(f"ray_conv_{i}/kernel", conv.weight, lambda a: a.transpose(2, 1, 0)),
                    (f"ray_conv_{i}/bias", conv.bias, _same)]
    for name in ("state_proj", "fuse", "pi_mean", "vf"):
        entries += _dense(name, getattr(model, name))
    entries.append(("log_std", model.log_std, _same))
    return entries


def attention_params_from_flax(params: Mapping, model: Optional[SceneTransformerPolicy] = None
                               ) -> SceneTransformerPolicy:
    """A flax SceneTransformerPolicy tree into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else SceneTransformerPolicy()
    return _load(params, _attention_entries(model), model)


def _attention_entries(model: SceneTransformerPolicy) -> list:
    def qkv_kernel(a):          # (D, H, Dh) -> (H*Dh, D)
        return a.reshape(a.shape[0], -1).T

    def out_kernel(a):          # (H, Dh, D) -> (D, H*Dh)
        return a.reshape(-1, a.shape[-1]).T

    def layer_norm(name, ln):
        return [(f"{name}/scale", ln.weight, _same), (f"{name}/bias", ln.bias, _same)]

    entries = []
    for name in ("embed_ego", "embed_neighbor", "embed_lidar", "pi_mean", "vf"):
        entries += _dense(name, getattr(model, name))
    entries += [("pos", model.pos, _same), ("log_std", model.log_std, _same)]
    entries += layer_norm("LayerNorm_0", model.ln_f)
    for i, blk in enumerate(model.blocks):
        b = f"block_{i}"
        mha = f"{b}/MultiHeadDotProductAttention_0"
        for proj in ("query", "key", "value"):
            lin = getattr(blk.attn, proj)
            entries += [(f"{mha}/{proj}/kernel", lin.weight, qkv_kernel),
                        (f"{mha}/{proj}/bias", lin.bias, lambda a: a.reshape(-1))]
        entries += [(f"{mha}/out/kernel", blk.attn.out.weight, out_kernel),
                    (f"{mha}/out/bias", blk.attn.out.bias, _same)]
        entries += layer_norm(f"{b}/LayerNorm_0", blk.ln_0) + layer_norm(f"{b}/LayerNorm_1",
                                                                           blk.ln_1)
        entries += _dense(f"{b}/Dense_0", blk.dense_0) + _dense(f"{b}/Dense_1", blk.dense_1)
    return entries


def central_params_from_flax(params: Mapping, model: Optional[CentralizedActorCritic] = None
                             ) -> CentralizedActorCritic:
    """A flax CentralizedActorCritic tree into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else CentralizedActorCritic()
    return _load(params, _central_entries(model), model)


def _central_entries(model: CentralizedActorCritic) -> list:
    entries = []
    for i, lin in enumerate(model.torso):
        entries += _dense(f"torso_{i}", lin)
    for name in ("pi_mean", "critic_embed", "critic_joint", "vf"):
        entries += _dense(name, getattr(model, name))
    entries.append(("log_std", model.log_std, _same))
    return entries


def gru_params_from_flax(params: Mapping, model: Optional[RecurrentActorCritic] = None
                         ) -> RecurrentActorCritic:
    """A flax RecurrentActorCritic tree into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else RecurrentActorCritic()
    return _load(params, _gru_entries(model), model)


def _gru_entries(model: RecurrentActorCritic) -> list:
    cell, H = model.gru, model.gru_features
    entries = _dense("torso_0", model.torso_0) + _dense("pi_mean", model.pi_mean) \
        + _dense("vf", model.vf) + [("log_std", model.log_std, _same)]
    with torch.no_grad():           # row blocks of the fused matrices, as views
        for g, gate in enumerate("rzn"):
            rows = slice(g * H, (g + 1) * H)
            entries += [(f"gru/i{gate}/kernel", cell.w_ih[rows], _transposed),
                        (f"gru/i{gate}/bias", cell.b_ih[rows], _same),
                        (f"gru/h{gate}/kernel", cell.w_hh[rows], _transposed)]
    entries.append(("gru/hn/bias", cell.b_hn, _same))
    return entries


def sac_actor_params_from_flax(params: Mapping, model: Optional[SquashedGaussianActor] = None
                               ) -> SquashedGaussianActor:
    """A flax SquashedGaussianActor tree into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else SquashedGaussianActor()
    return _load(params, _sac_actor_entries(model), model)


def _sac_actor_entries(model: SquashedGaussianActor) -> list:
    entries = []
    for i, lin in enumerate(model.torso):
        entries += _dense(f"torso_{i}", lin)
    entries += _dense("mean", model.mean) + _dense("log_std", model.log_std)
    return entries


def sac_critic_params_from_flax(params: Mapping, model: Optional[TwinQCritic] = None
                                ) -> TwinQCritic:
    """The JAX package's stacked twin QCritic tree (leaves with a leading
    axis of 2) into ``model`` (default: a new bf16 one)."""
    model = model if model is not None else TwinQCritic()
    names = [f"torso_{i}" for i in range(len(model.kernels) - 1)] + ["q"]
    entries = []
    for name, w, b in zip(names, model.kernels, model.biases):
        entries += [(f"{name}/kernel", w, _same), (f"{name}/bias", b, _same)]
    return _load(params, entries, model)


FROM_FLAX = {"mlp": mlp_params_from_flax, "conv": conv_params_from_flax,
             "attention": attention_params_from_flax, "central": central_params_from_flax,
             "gru": gru_params_from_flax, "sac": sac_actor_params_from_flax}
ENTRIES = {"mlp": _mlp_entries, "conv": _conv_entries, "attention": _attention_entries,
           "central": _central_entries, "gru": _gru_entries, "sac": _sac_actor_entries}


def leaf_paths(tree: Mapping, prefix: str = "") -> set:
    """The '/'-joined paths of a nested dict's leaves."""
    out = set()
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out |= leaf_paths(v, path + "/") if isinstance(v, Mapping) else {path}
    return out


def params_from_flax(kind: str, params: Mapping, model: Optional[torch.nn.Module] = None,
                     strict: bool = False) -> torch.nn.Module:
    """The flax tree of family ``kind`` in the port's module of that family.
    ``strict``: the tree must hold exactly the leaves the family reads, so a
    store of another family raises ValueError even where its leaves that this
    family reads happen to fit."""
    if model is None:
        model = make_model(kind)
    if strict:
        want = {path for path, _, _ in ENTRIES[kind](model)}
        have = leaf_paths(params.get("params", params))
        if want != have:
            raise ValueError(f"not a {kind!r} store: its leaves {sorted(have ^ want)[:4]} ... "
                             f"differ from the family's")
    return FROM_FLAX[kind](params, model)


def env_state_from_numpy(ego: Mapping, lidar, step_count, device="cpu",
                         batched: bool = True, npc: Optional[Mapping] = None) -> EnvState:
    """An ``EnvState`` from the JAX package's leaves as numpy arrays.

    ``ego`` and ``npc`` map EgoState and NpcState field names to arrays
    (without ``npc``, the state has no NPC pool); ``batched=False`` takes a
    single env's (N,) / (M,) / () leaves and adds the env axis.
    """
    def t(a):
        a = np.asarray(a)
        if not batched:
            a = a[None]
        return torch.from_numpy(np.array(a)).to(device)

    e = EgoState(**{f: t(ego[f]) for f in EgoState._fields})
    pool = NpcState(**{f: t(npc[f]) for f in NpcState._fields}) if npc is not None else None
    return EnvState(ego=e, lidar=t(lidar), step_count=t(np.asarray(step_count, np.int32)),
                    npc=pool)


def env_state_to_numpy(state: EnvState) -> dict:
    """The state's leaves as numpy arrays: ``{"ego": {field: array}, "lidar",
    "step_count", "npc": {field: array} or None}``, each with the env axis
    first."""
    npc = None if state.npc is None else {f: getattr(state.npc, f).cpu().numpy()
                                          for f in NpcState._fields}
    return {"ego": {f: getattr(state.ego, f).cpu().numpy() for f in EgoState._fields},
            "lidar": state.lidar.cpu().numpy(),
            "step_count": state.step_count.cpu().numpy(), "npc": npc}
