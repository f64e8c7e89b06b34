"""The train step's entry: the program's PPO learner,
``PPOLearner.jit_train_step()`` (portbench/learner.py)."""
from ..learner import TrainStep as Entry  # noqa: F401
