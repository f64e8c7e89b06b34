"""Carry weights and env state between the JAX package and the port.

Both directions go through numpy, so the port imports nothing of JAX:

  * ``mlp_params_from_flax`` loads a flax ``ActorCriticMLP`` parameter tree
    (``torso_0/kernel``, ..., ``pi_mean``, ``vf``, ``log_std``), given as
    nested dicts of numpy arrays, into the port's module. Flax kernels are
    (in, out); ``nn.Linear`` weights are (out, in).
  * ``env_state_from_numpy`` / ``env_state_to_numpy`` convert an ``EnvState``
    given as the JAX package's leaves (``ego``'s fields, ``lidar``,
    ``step_count``) so that a lockstep can start from a JAX state.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.env import EgoState, EnvState
from .models.actor_critic import ActorCriticMLP


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
    layers = [(f"torso_{i}", m) for i, m in enumerate(model.torso)]
    layers += [("pi_mean", model.pi_mean), ("vf", model.vf)]
    with torch.no_grad():
        for name, lin in layers:
            kernel = np.asarray(p[name]["kernel"], np.float32)
            bias = np.asarray(p[name]["bias"], np.float32)
            if kernel.shape != (lin.in_features, lin.out_features):
                raise ValueError(f"{name}: kernel {kernel.shape} does not fit "
                                 f"({lin.in_features}, {lin.out_features})")
            lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
            lin.bias.copy_(torch.from_numpy(bias))
        model.log_std.copy_(torch.from_numpy(np.asarray(p["log_std"], np.float32)))
    return model


def env_state_from_numpy(ego: Mapping, lidar, step_count, device="cpu",
                         batched: bool = True) -> EnvState:
    """An ``EnvState`` from the JAX package's leaves as numpy arrays.

    ``ego`` maps EgoState field names to arrays; ``batched=False`` takes a
    single env's (N,) leaves and adds the env axis.
    """
    def t(a):
        a = np.asarray(a)
        if not batched:
            a = a[None]
        return torch.from_numpy(np.array(a)).to(device)

    e = EgoState(**{f: t(ego[f]) for f in EgoState._fields})
    return EnvState(ego=e, lidar=t(lidar), step_count=t(np.asarray(step_count, np.int32)))


def env_state_to_numpy(state: EnvState) -> dict:
    """The state's leaves as numpy arrays: ``{"ego": {field: array}, "lidar",
    "step_count"}``, each with the env axis first."""
    return {"ego": {f: getattr(state.ego, f).cpu().numpy() for f in EgoState._fields},
            "lidar": state.lidar.cpu().numpy(),
            "step_count": state.step_count.cpu().numpy()}
