"""Learners: PPO over the batched env."""
from .ppo import PPOConfig, PPOLearner, TrainState, Transition

__all__ = ["PPOConfig", "PPOLearner", "TrainState", "Transition"]
