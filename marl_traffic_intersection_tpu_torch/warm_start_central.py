"""Warm-start a MAPPO (central) snapshot from a trained mlp policy.

The port's counterpart of scripts/warm_start_central.py. The centralised
model's actor (``torso``, ``pi_mean``, ``log_std``; models/central.py) has
the mlp family's layout, so a trained decentralised policy transplants into
it directly; only the centralised critic (``critic_embed``,
``critic_joint``, ``vf``) starts fresh.

  python -m marl_traffic_intersection_tpu_torch.warm_start_central \\
      --source policy_mlp_cfg1 --out runs/central_warm --agents 4
  python -m marl_traffic_intersection_tpu_torch.train --model central \\
      --resume runs/central_warm --critic-warmup 100

``--source`` is a shipped mlp policy (a bare name, ``artifacts/<name>`` or
its ``.npz`` export) or a checkpoint of the port's train whose model has the
actor. The output is a snapshot of the port's train: the transplanted model,
a fresh Adam and update 0. The surgery runs on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from .convert import params_from_flax
from .models import make_model
from .utils.checkpoint import read_export, resolve_policy, restore_checkpoint, save_checkpoint

ACTOR = ("torso.", "pi_mean.", "log_std")


def actor_names(model: torch.nn.Module) -> list:
    """The names of ``model``'s parameters that belong to the actor."""
    return [k for k in model.state_dict() if k.startswith(ACTOR)]


def source_state(source) -> dict:
    """The state dict of ``source``'s model: a shipped mlp export, or a
    checkpoint of the port's train."""
    kind, path = resolve_policy(source)
    if kind == "snapshot":
        return restore_checkpoint(path)["model"]
    tree = read_export(path)
    try:
        return params_from_flax("mlp", tree["params"]).state_dict()
    except (KeyError, ValueError) as e:
        raise ValueError(f"source {source} lacks the mlp actor: {e}") from None


def warm_start(source, out) -> list:
    """Write a ``central`` snapshot to ``out`` whose actor is ``source``'s and
    whose critic is fresh (seed 0); returns the transplanted parameter names."""
    central = make_model("central")
    src = source_state(source)
    shared = actor_names(central)
    missing = [k for k in shared if k not in src]
    if missing:
        raise ValueError(f"source {source} lacks actor modules {missing}")
    dst = central.state_dict()
    for k in shared:
        if tuple(src[k].shape) != tuple(dst[k].shape):
            raise ValueError(f"source {source}: {k} is {tuple(src[k].shape)}, the central "
                             f"model's actor holds {tuple(dst[k].shape)}")
        dst[k] = src[k]
    central.load_state_dict(dst)
    optimizer = torch.optim.Adam(central.parameters(), eps=1e-8)   # train sets its --lr
    save_checkpoint(out, {"model": central.state_dict(), "optimizer": optimizer.state_dict(),
                          "update": 0})
    return shared


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="policy_mlp_cfg1")
    ap.add_argument("--out", required=True)
    ap.add_argument("--agents", type=int, default=4,
                    help="accepted for scripts/warm_start_central.py's sake: the central "
                         "model's parameters do not depend on the agent count")
    args = ap.parse_args(argv)
    shared = warm_start(args.source, args.out)
    print(f"transplanted {shared} from {args.source} -> {args.out}")


if __name__ == "__main__":
    main()
