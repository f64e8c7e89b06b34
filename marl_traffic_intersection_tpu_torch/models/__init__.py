"""Policy/value model families for the intersection MARL task."""
from __future__ import annotations

import torch

from .actor_critic import ActorCriticMLP, logp_and_entropy, sample_action
from .attention import SceneTransformerPolicy
from .central import CentralizedActorCritic
from .conv import LidarConvPolicy
from .recurrent import RecurrentActorCritic
from .sac import SquashedGaussianActor, TwinQCritic, sample_squashed

MODEL_FAMILIES = {
    "mlp": ActorCriticMLP,
    "attention": SceneTransformerPolicy,
    "conv": LidarConvPolicy,
    "gru": RecurrentActorCritic,        # recurrent: needs RecurrentPPOLearner
    "central": CentralizedActorCritic,  # MAPPO-style centralized critic
    "sac": SquashedGaussianActor,       # the SAC learner's policy (parallel/sac.py)
}


def make_model(kind: str, seed: int = 0, **kwargs) -> torch.nn.Module:
    """A model family by name ('mlp' | 'attention' | 'conv' | 'gru' | 'central'
    | 'sac', the last the SAC actor), its parameters drawn on the CPU from
    ``seed`` without touching torch's global generator."""
    if kind not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {kind!r}; choose from {sorted(MODEL_FAMILIES)}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return MODEL_FAMILIES[kind](**kwargs)


__all__ = ["ActorCriticMLP", "SceneTransformerPolicy", "LidarConvPolicy",
           "RecurrentActorCritic", "CentralizedActorCritic", "SquashedGaussianActor",
           "TwinQCritic", "MODEL_FAMILIES", "make_model", "sample_action", "sample_squashed",
           "logp_and_entropy"]
