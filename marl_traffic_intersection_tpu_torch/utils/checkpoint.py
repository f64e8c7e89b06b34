"""Checkpoint/restore of a training snapshot, with torch.save.

The port's counterpart of marl_traffic_intersection_tpu/utils/checkpoint.py,
without orbax (reading the JAX package's orbax artifacts is ROADMAP queue 1
item 10). A checkpoint is a directory holding one file written by
``torch.save``: a nested dict of tensors, numbers and strings, which
``torch.load(weights_only=True)`` reads back without unpickling code. The
file is written beside its final name and renamed over it, so a run killed
while saving leaves the previous checkpoint whole.

``env_state_to_dict`` / ``env_state_from_dict`` turn the env's state (an
``EnvState`` with its NPC pool, or a ``NormState`` around one) into such a
dict and back.
"""
from __future__ import annotations

import os
import pathlib
from typing import Any

import torch

from ..core.env import EgoState, EnvState
from ..core.npc import NpcState
from ..envs.normalize import NormState

FILE = "checkpoint.pt"


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
