"""Checkpoint/restore of a training snapshot, with torch.save, and the
shipped policies.

The port's counterpart of marl_traffic_intersection_tpu/utils/checkpoint.py,
without orbax. A checkpoint is a directory holding one file written by
``torch.save``: a nested dict of tensors, numbers and strings, which
``torch.load(weights_only=True)`` reads back without unpickling code. The
file is written beside its final name and renamed over it, so a run killed
while saving leaves the previous checkpoint whole.

The JAX package ships its trained policies as orbax OCDBT stores
(``artifacts/policy_*``), whose compressed B-tree the port does not read.
Their weights are committed beside the port instead, one uncompressed numpy
``.npz`` per artifact in ``artifacts/`` of this package, made from the stores
by ``python -m tests._torch_port export-policies`` and held bit for bit
against them by ``tests/test_torch_artifacts.py``. An export's keys are the
flax paths joined by ``/`` under ``params`` (PPO families) or
``actor_params`` and ``q_params`` (SAC). ``load_policy`` and ``load_sac``
read a port snapshot or a shipped export (``artifacts/policy_gru_multi`` and
``policy_gru_multi`` both name the export ``policy_gru_multi.npz``).

Each PPO-family store's Adam state is exported beside its weights, as
``<name>.adam.npz``: optax's ``count``, its moments ``mu/<flax path>`` and
``nu/<flax path>``, and the store's ``update``. ``load_train_state`` reads a
store's weights and Adam state together, for fine-tunes that resume a
shipped policy; the SAC stores hold no optimizer state.

``env_state_to_dict`` / ``env_state_from_dict`` turn the env's state (an
``EnvState`` with its NPC pool, or a ``NormState`` around one) into such a
dict and back.
"""
from __future__ import annotations

import os
import pathlib
import copy
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_flax, sac_actor_params_from_flax, sac_critic_params_from_flax
from ..core.env import EgoState, EnvState
from ..core.npc import NpcState
from ..envs.normalize import NormState
from ..models import make_model
from ..models.sac import TwinQCritic

FILE = "checkpoint.pt"
EXPORTS = pathlib.Path(__file__).resolve().parents[1] / "artifacts"


def checkpoint_exists(path: str) -> bool:
    return (pathlib.Path(path) / FILE).is_file()


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors may lie on any device) to the directory ``path``."""
    d = pathlib.Path(path)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"{FILE}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, d / FILE)


def restore_checkpoint(path: str, device="cpu") -> Any:
    """The tree saved in the directory ``path``, its tensors on ``device``."""
    f = pathlib.Path(path) / FILE
    if not f.is_file():
        raise FileNotFoundError(f"no checkpoint at {path} ({f} is missing)")
    return torch.load(f, map_location=device, weights_only=True)


def env_state_to_dict(state) -> dict:
    """An ``EnvState`` or ``NormState`` as a flat dict of tensors."""
    norm = isinstance(state, NormState)
    es = state.env_state if norm else state
    d = {f"ego.{f}": getattr(es.ego, f) for f in EgoState._fields}
    d.update(lidar=es.lidar, step_count=es.step_count)
    if es.npc is not None:
        d.update({f"npc.{f}": getattr(es.npc, f) for f in NpcState._fields})
    if norm:
        d.update({f"norm.{f}": getattr(state, f) for f in ("ret", "count", "mean", "m2")})
    return d


def env_state_from_dict(d: dict, device):
    """The state ``env_state_to_dict`` saved, on ``device``; a ``NormState``
    when the dict holds the normalizer's statistics."""
    t = {k: v.to(device) for k, v in d.items()}
    npc = NpcState(**{f: t[f"npc.{f}"] for f in NpcState._fields}) if "npc.alive" in t \
        else None
    es = EnvState(ego=EgoState(**{f: t[f"ego.{f}"] for f in EgoState._fields}),
                  lidar=t["lidar"], step_count=t["step_count"], npc=npc)
    if "norm.ret" not in t:
        return es
    return NormState(env_state=es, **{f: t[f"norm.{f}"] for f in ("ret", "count", "mean", "m2")})


def read_export(path) -> dict:
    """A shipped policy's ``.npz`` export as a nested dict of float32 arrays."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


def resolve_policy(path) -> Tuple[str, pathlib.Path]:
    """("snapshot", directory) for a checkpoint of the port, ("export", file)
    for a shipped policy: an ``.npz`` file, or a bare name or
    ``artifacts/<name>`` naming one of the committed exports.
    FileNotFoundError naming both places otherwise, so that a run directory
    that happens to share a shipped policy's name never loads its weights."""
    p = pathlib.Path(path)
    if checkpoint_exists(p):
        return "snapshot", p
    shipped = len(p.parts) == 1 or p.parent.name == "artifacts"
    export = p if p.suffix == ".npz" and p.is_file() \
        else EXPORTS / f"{p.name.removesuffix('.npz')}.npz"
    if export.is_file() and (export == p or shipped):
        return "export", export
    raise FileNotFoundError(f"no policy at {path}: neither a checkpoint of the port "
                            f"({p / FILE}) nor a shipped policy's export ({export})")


class ShippedTrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    update: int


def load_train_state(path, model_kind: str,
                     model: Optional[torch.nn.Module] = None) -> ShippedTrainState:
    """A shipped PPO-family store's train state: the model (``model``, or a
    new one of ``model_kind``) holding its weights, a ``torch.optim.Adam``
    over it (optax's adam: eps 1e-8, lr 3e-4, train's default; train sets
    its ``--lr`` in the param groups) whose ``exp_avg`` and
    ``exp_avg_sq`` are optax's ``mu`` and ``nu`` and whose ``step`` is optax's
    ``count``, and the store's ``update``.

    The moments are laid out as the parameters are, through the same
    converter (convert.py) loading them into a copy of the model. A store of
    another family, or one without an Adam export (SAC), raises ValueError."""
    kind, p = resolve_policy(path)
    if kind != "export":
        raise ValueError(f"{path} is a checkpoint of the port, not a shipped store; "
                         "restore_checkpoint reads it")
    adam_file = p.with_name(p.name.removesuffix(".npz") + ".adam.npz")
    if not adam_file.is_file():
        raise ValueError(f"{p.name} holds no optimizer state ({adam_file.name} is missing)")
    model = model if model is not None else make_model(model_kind)
    params_from_flax(model_kind, read_export(p)["params"], model, strict=True)
    adam = read_export(adam_file)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, eps=1e-8)
    step = float(adam["count"])
    moments = {}
    for name in ("mu", "nu"):
        holder = copy.deepcopy(model)
        params_from_flax(model_kind, adam[name], holder, strict=True)
        moments[name] = list(holder.parameters())
    for param, mu, nu in zip(model.parameters(), moments["mu"], moments["nu"]):
        optimizer.state[param] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu.detach().to(param.device, copy=True),
            "exp_avg_sq": nu.detach().to(param.device, copy=True)}
    return ShippedTrainState(model, optimizer, int(adam["update"]))


def load_sac(path, device="cpu") -> Tuple[torch.nn.Module, TwinQCritic]:
    """The SAC actor and twin critic of a checkpoint of the port's train_sac
    or of a shipped SAC export, on ``device``."""
    kind, p = resolve_policy(path)
    if kind == "snapshot":
        tree = restore_checkpoint(p)
        actor, critic = make_model("sac"), TwinQCritic()
        actor.load_state_dict(tree["actor_params"])
        critic.load_state_dict(tree["q_params"])
    else:
        tree = read_export(p)
        actor = sac_actor_params_from_flax(tree["actor_params"])
        critic = sac_critic_params_from_flax(tree["q_params"])
    return actor.to(device), critic.to(device)


def load_policy(path, model_kind: str, device="cpu") -> Tuple[torch.nn.Module, Callable]:
    """A trained policy of family ``model_kind`` for deterministic inference,
    from a checkpoint of the port (train, or train_sac for 'sac') or a
    shipped export: ``(model on device, mean_fn)``. ``mean_fn(obs)`` is the
    pre-tanh action mean; for 'gru', ``mean_fn(obs, h)`` returns ``(mean,
    h_new)`` and the caller carries the hidden state."""
    if model_kind == "sac":
        model = load_sac(path, device)[0]
    else:
        kind, p = resolve_policy(path)
        if kind == "snapshot":
            model = make_model(model_kind)
            model.load_state_dict(restore_checkpoint(p)["model"])
        else:
            model = params_from_flax(model_kind, read_export(p)["params"])
        model = model.to(device)
    model.eval()
    if model_kind == "gru":
        def mean_fn(obs, h):
            mean, _, _, h_new = model(obs, h)
            return mean, h_new
    else:
        def mean_fn(obs):
            return model(obs)[0]
    return model, torch.no_grad()(mean_fn)
