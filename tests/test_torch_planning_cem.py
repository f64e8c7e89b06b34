"""The port's CEM beats its random shooting at an equal rollout budget on
config 1's left turn (CPU), the counterpart of tests/test_planning.py's
second test; apart from tests/test_torch_planning.py to keep each file
short."""
import numpy as np
import torch

from marl_traffic_intersection_tpu_torch.algos import cem_policy, mpc_policy

from .test_torch_planning import LEFT, H, K, _closed_loop, _snapshots


def test_cem_beats_random_shooting_at_equal_budget():
    """tests/test_planning.py's second test: CEM (16 candidates x 4
    iterations) beats random shooting (64 candidates) on the left turn,
    closed-loop over 40 steps with receding-horizon warm starts."""
    _, _, penv, ps = _snapshots(LEFT)

    def shooting(seed):
        mpc = mpc_policy(penv, num_candidates=K, horizon=H, seed=seed)
        return _closed_loop(penv, ps, lambda st: mpc(st)[0])

    def cem(seed):
        plan = cem_policy(penv, seed=seed, num_candidates=16, num_iters=4, num_elites=4,
                          horizon=H)
        warm = [torch.zeros(H, 1, 2)]

        def act(st):
            a, _, warm[0] = plan(st, warm[0])
            return a
        return _closed_loop(penv, ps, act)

    shoot = np.mean([shooting(s) for s in (1, 2)])
    ce = np.mean([cem(s) for s in (1, 2)])
    assert ce > shoot, (ce, shoot)
