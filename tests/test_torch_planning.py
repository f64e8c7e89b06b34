"""Snapshot planning in the port (algos/mcts.py, CPU) against the JAX
package's: random shooting with JAX's own draws injected (the best action
and its return bit for bit), CEM with JAX's normals injected (within
CEM_TOL), the snapshot unchanged by planning, the counterparts of
tests/test_planning.py's first test (planning beats random actions; its
second is in tests/test_torch_planning_cem.py), and with traffic one spawn draw per horizon
step shared by every candidate.

The JAX planners step ``env.step`` with the observation; their returns read
only the rewards, so the JAX side plans through a view of the env whose step
skips the observation (whose exact chain takes minutes to compile), on the
reference float chain (``exact_obs=True``, compiled without algsimp, H8).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.algos import mcts as jax_mcts
from marl_traffic_intersection_tpu_torch.algos import (cem_plan, mpc_policy,
                                                       random_shooting_plan)
from marl_traffic_intersection_tpu_torch.core.constants import DT_DEFAULT
from marl_traffic_intersection_tpu_torch.core.npc import spawn_decision

from ._torch_port import EXACT_COMPILE, assert_bits, jax_env, port_env

STRAIGHT, LEFT = ("IN_1", "OUT_7"), ("IN_6", "OUT_2")
K, H = 64, 12
# CEM's elites are averaged in another order (jnp.mean/std against
# torch.mean/std), and its candidates are clipped sums of those averages:
# float32 rounding of sums of 4-16 terms, carried over 4 iterations
CEM_TOL = 1e-5


def _snapshots(route, seed=0, **cfg):
    """The JAX env, its snapshot, and the port's env and snapshot (B = 1) of
    config 1 on ``route``."""
    jenv = jax_env(1, max_steps=4000, **cfg)
    penv = port_env(1, max_steps=4000, **cfg)
    rid = jenv.table.route_ids([route])
    return jenv, jenv.reset_state(jax.random.PRNGKey(seed), rid), penv, penv.reset_state(rid)


def _no_obs(jenv):
    """The JAX env as its planners see it, stepping without the observation."""
    return types.SimpleNamespace(config=jenv.config,
                                 step=lambda s, a: jenv.step(s, a, with_obs=False))


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_COMPILE)


def test_random_shooting_matches_jax_with_its_draws():
    jenv, js, penv, ps = _snapshots(STRAIGHT)
    plan = _compiled(lambda s, k: jax_mcts.random_shooting_plan(
        _no_obs(jenv), s, k, num_candidates=K, horizon=H), js, jax.random.PRNGKey(0))
    for seed in range(1, 7):
        key = jax.random.PRNGKey(seed)
        # the draws of mcts.py:40-50
        k1, k2 = jax.random.split(key)
        noise = jax.random.uniform(k1, (H, K, 1, 2), jnp.float32, -1.0, 1.0)
        a0 = jax.random.uniform(k2, (K, 1, 2), jnp.float32, -1.0, 1.0)
        j_act, j_ret = plan(js, key)
        p_act, p_ret = random_shooting_plan(
            penv, ps, num_candidates=K, horizon=H,
            noise=torch.from_numpy(np.array(noise)), a0=torch.from_numpy(np.array(a0)))
        assert_bits("best action", np.asarray(j_act), p_act, f"seed {seed}")
        assert_bits("best return", np.asarray(j_ret), p_ret, f"seed {seed}")


def test_cem_matches_jax_with_its_normals():
    jenv, js, penv, ps = _snapshots(LEFT)
    kw = dict(num_candidates=16, num_iters=4, num_elites=4, horizon=H)
    warm = jnp.zeros((H, 1, 2), jnp.float32)
    plan = _compiled(lambda s, k, m: jax_mcts.cem_plan(_no_obs(jenv), s, k, init_mean=m, **kw),
                     js, jax.random.PRNGKey(0), warm)
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        normals = np.stack([np.array(jax.random.normal(k, (H, 16, 1, 2), jnp.float32))
                            for k in jax.random.split(key, 4)])
        j_act, j_best, j_mean = plan(js, key, warm)
        p_act, p_best, p_mean = cem_plan(penv, ps, init_mean=torch.zeros(H, 1, 2),
                                         normals=torch.from_numpy(normals), **kw)
        scale = float(np.abs(np.asarray(j_mean)).max())
        assert float(np.abs(np.asarray(j_mean) - p_mean.numpy()).max()) <= CEM_TOL * scale, seed
        assert float(np.abs(np.asarray(j_act) - p_act.numpy()).max()) <= CEM_TOL * scale, seed
        assert abs(float(j_best) - float(p_best)) <= CEM_TOL * max(1.0, abs(float(j_best)))


def _leaves(state):
    return [t.clone() for t in (*state.ego, state.lidar, state.step_count, *state.npc)]


def test_planning_leaves_the_snapshot_unchanged():
    _, _, penv, ps = _snapshots(LEFT)
    before = _leaves(ps)
    g = torch.Generator().manual_seed(0)
    random_shooting_plan(penv, ps, g, num_candidates=8, horizon=4)
    cem_plan(penv, ps, g, num_candidates=8, num_iters=2, num_elites=2, horizon=4)
    for i, (a, b) in enumerate(zip(before, _leaves(ps))):
        assert_bits(f"snapshot leaf {i}", a, b)


def _closed_loop(penv, state, plan, steps=40):
    total, st = 0.0, state
    for _ in range(steps):
        act = plan(st)
        st, out = penv.step(st, act.reshape(1, 1, 2))
        total += float(out.reward.sum())
    return total


def test_random_shooting_planner_beats_random():
    """tests/test_planning.py's first test: the planned actions make more
    progress than random ones on the straight route."""
    _, _, penv, ps = _snapshots(STRAIGHT)
    mpc = mpc_policy(penv, num_candidates=K, horizon=H, seed=1)
    total_plan = _closed_loop(penv, ps, lambda st: mpc(st)[0])
    rng = np.random.RandomState(0)
    total_rand = _closed_loop(
        penv, ps, lambda st: torch.from_numpy(rng.uniform(-1, 1, (1, 2)).astype(np.float32)))
    assert total_plan > total_rand + 0.1, (total_plan, total_rand)


@pytest.mark.parametrize("injected", [False, True])
def test_traffic_candidates_share_the_spawn_draw(injected):
    """Config 2's env (1 agent on the left turn, traffic), K = 8, H = 4: every
    candidate gets the same spawn at every horizon step. Injected draws at
    config 2's density 0.5; the planner's own draws at density 60, so that
    they spawn, replayed from a generator of the same seed (noise, a0, then
    one env's spawn draw per step) into a second plan that must agree bit
    for bit."""
    density = 0.5 if injected else 60.0
    _, _, penv, ps = _snapshots(LEFT, traffic_flow=True, traffic_density=density)
    seen = []

    def score(out):
        seen.append(out.spawned.clone())
        return out.reward.sum(-1)

    if injected:
        do_try = [True, False, False, True]
        spawns = [(torch.tensor([d]), torch.tensor([5 * t], dtype=torch.int32))
                  for t, d in enumerate(do_try)]
        random_shooting_plan(penv, ps, num_candidates=8, horizon=4, score_fn=score,
                             noise=torch.zeros(4, 8, 1, 2), a0=torch.zeros(8, 1, 2),
                             spawns=spawns)
        assert bool(seen[0].all()) and not any(bool(seen[t].any()) for t in (1, 2)), seen
    else:
        got = random_shooting_plan(penv, ps, torch.Generator().manual_seed(4), num_candidates=8,
                                   horizon=4, score_fn=score)
        g = torch.Generator().manual_seed(4)
        noise = torch.rand((4, 8, 1, 2), generator=g) * 2.0 - 1.0
        a0 = torch.rand((8, 1, 2), generator=g) * 2.0 - 1.0
        spawns = [spawn_decision(g, 1, penv.traffic_ids.shape[0], density, DT_DEFAULT)
                  for _ in range(4)]
        replayed = random_shooting_plan(penv, ps, num_candidates=8, horizon=4, noise=noise,
                                        a0=a0, spawns=spawns)
        for name, a, b in zip(("best action", "best return"), got, replayed):
            assert_bits(name, a, b)
    assert len(seen) == 4 and any(bool(s.any()) for s in seen), seen
    for t, s in enumerate(seen):
        assert bool((s == s[0]).all()), (t, s)
