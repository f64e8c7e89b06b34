"""Policy/value model families for the intersection MARL task."""
from __future__ import annotations

import torch

from .actor_critic import ActorCriticMLP, logp_and_entropy, sample_action
from .attention import SceneTransformerPolicy
from .central import CentralizedActorCritic
from .conv import LidarConvPolicy

MODEL_FAMILIES = {
    "mlp": ActorCriticMLP,
    "attention": SceneTransformerPolicy,
    "conv": LidarConvPolicy,
    "central": CentralizedActorCritic,  # MAPPO-style centralized critic
}


def make_model(kind: str, seed: int = 0, **kwargs) -> torch.nn.Module:
    """A model family by name ('mlp' | 'attention' | 'conv' | 'central'), its
    parameters drawn on the CPU from ``seed`` without touching torch's global
    generator."""
    if kind == "gru":
        raise NotImplementedError("model 'gru' needs the recurrent learner "
                                  "(parallel/recurrent_ppo.py): ROADMAP queue 1 item 13")
    if kind not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {kind!r}; choose from {sorted(MODEL_FAMILIES)}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return MODEL_FAMILIES[kind](**kwargs)


__all__ = ["ActorCriticMLP", "SceneTransformerPolicy", "LidarConvPolicy",
           "CentralizedActorCritic", "MODEL_FAMILIES", "make_model", "sample_action",
           "logp_and_entropy"]
