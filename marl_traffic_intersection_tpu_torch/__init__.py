"""marl_traffic_intersection_tpu_torch: the PyTorch/CUDA port of
marl_traffic_intersection_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it,
nor of JAX. Entry points run on the card unless the caller passes
``device="cpu"``. Every kernel the JAX package wrote in Pallas for the TPU is
a kernel written by hand for Hopper here (csrc/), with a plain PyTorch
version beside it that the CPU path runs.
"""
from .core.constants import OBS_DIM, STATUS_NAMES
from .core.env import EnvConfig, EnvState, IntersectionEnv, RewardParams, StepOutput
from .core.routes import RouteTable, build_route_table, default_ego_routes
from .envs.vector import VectorEnv
from .models.actor_critic import ActorCriticMLP

__all__ = [
    "ActorCriticMLP",
    "EnvConfig",
    "EnvState",
    "IntersectionEnv",
    "OBS_DIM",
    "RewardParams",
    "RouteTable",
    "STATUS_NAMES",
    "StepOutput",
    "VectorEnv",
    "build_route_table",
    "default_ego_routes",
]
