"""Learners: PPO over the batched env, its truncated-BPTT variant for the
GRU family, and SAC."""
from .ppo import PPOConfig, PPOLearner, TrainState, Transition
from .recurrent_ppo import RecTransition, RecurrentPPOLearner
from .sac import ReplayBuffer, SACConfig, SACLearner, SACState

__all__ = ["PPOConfig", "PPOLearner", "TrainState", "Transition", "RecTransition",
           "RecurrentPPOLearner", "ReplayBuffer", "SACConfig", "SACLearner", "SACState"]
