"""Decision-making on top of the batched env: snapshot planning."""
from .mcts import cem_plan, cem_policy, mpc_policy, random_shooting_plan

__all__ = ["cem_plan", "cem_policy", "mpc_policy", "random_shooting_plan"]
