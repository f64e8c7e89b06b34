"""The port's GymIntersectionEnv against the JAX package's, episode for
episode: observations, rewards, status, done and every ``info`` key, bit for
bit, the JAX side with ``exact_obs=True``.

The JAX wrapper's own jitted step would compile its exact observation for
minutes and divide by a constant through its reciprocal (ROADMAP queue 3,
H8), so each JAX gym here steps without its observation, through a step
compiled on the reference chain (``EXACT_COMPILE``; with traffic,
``ieee_constant_division``, H10), and resets without it. The observations of
the whole episode, the reset's first, are built afterwards in one eager call
(``observe_all``) on the states the wrapper went through. Everything else the
JAX wrapper returns is its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core.npc import spawn_decision as jax_spawn_decision
from marl_traffic_intersection_tpu.core.env import IntersectionEnv as JaxEnv
from marl_traffic_intersection_tpu.envs.gym import GymIntersectionEnv as JaxGym
from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv

from ._torch_port import (EXACT_COMPILE, assert_bits, assert_npc_bits, ieee_constant_division,
                          observe_all, policy_random)

CONFIG1 = {"ego_routes": [("IN_6", "OUT_2")], "max_steps": 120}


_STEPPERS = {}


def jax_gym(config):
    """The JAX wrapper of ``config`` (exact_obs), stepping without its
    observation through a step compiled on the reference chain (once per
    config) and recording each new state in ``.states``."""
    def no_obs(core, key, rids=None):
        return core.reset_state(key, rids), np.zeros((core.config.num_agents, 127), np.float32)

    reset = JaxEnv.reset
    JaxEnv.reset = no_obs
    try:
        jg = JaxGym({**config, "exact_obs": True})
    finally:
        JaxEnv.reset = reset
    jg._core.reset = lambda key, rids=None: no_obs(jg._core, key, rids)
    key = repr(sorted(config.items()))
    if key not in _STEPPERS:
        fn = lambda s, a, dt: jg._core.step(s, a, dt, with_obs=False)
        args = (jg._state, jnp.zeros((jg.num_agents, 2), jnp.float32), jnp.float32(1 / 60))
        if jg.traffic_flow:
            with ieee_constant_division():
                _STEPPERS[key] = jax.jit(fn).lower(*args).compile()
        else:
            _STEPPERS[key] = jax.jit(fn).lower(*args).compile(compiler_options=EXACT_COMPILE)
    step = _STEPPERS[key]
    jg.states = []

    def stepper(s, a, dt):
        s, out = step(s, a, dt)
        jg.states.append(s)
        return s, out._replace(obs=np.zeros((jg.num_agents, 127), np.float32))

    jg._jit_step = stepper
    return jg


def substeps(frames, seed=0):
    """play.py's real-time loop: each frame's elapsed time (here seeded, 5 to
    50 ms) consumed as dt = min(remaining, 1/60)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(frames):
        remaining = min(float(rng.uniform(0.005, 0.05)), 0.25)
        while remaining > 1e-9:
            dt = min(remaining, 1.0 / 60.0)
            out.append(dt)
            remaining -= dt
    return out


def run_episode(config, dts, seed=3, spawn_draws=False, check_npcs=False):
    """Reset both wrappers with ``seed`` and step them with the same seeded
    random actions at the step lengths ``dts`` until the episode ends; hold
    every return value. Returns (steps, JAX gym, port gym, the port's infos)."""
    jg = jax_gym(config)
    queue = []
    pg = GymIntersectionEnv({**config, "device": "cpu"},
                            spawn_sampler=(lambda k: queue.pop(0)) if spawn_draws else None)
    jg.reset(seed=seed)
    jg.states.append(jg._state)
    pobs, _ = pg.reset(seed=seed)
    rng = np.random.RandomState(seed + 100)
    n, pobs_all, infos = jg.num_agents, [pobs], []
    T = int(jg._core._traffic_ids.shape[0]) if jg.traffic_flow else 0
    draw = jax.jit(lambda key, dt: jax_spawn_decision(jax.random.split(key)[1], T,
                                                      jg._cfg.traffic_density, dt))
    steps = 0
    for t, dt in enumerate(dts):
        a = policy_random(rng, n)
        act = a[0] if jg.traffic_flow else a
        if spawn_draws:       # the draw the JAX step makes from its key
            do_try, rc = draw(jg._state.key, jnp.float32(dt))
            queue.append((torch.tensor([bool(do_try)]), torch.tensor([int(rc)])))
        jr = jg.step(act, dt=dt)
        pr = pg.step(act, dt=dt)
        assert not queue
        steps += 1
        assert jr[1:4] == pr[1:4] if jg.traffic_flow else \
            (np.array_equal(jr[1].view(np.int32), pr[1].view(np.int32)) and jr[2:4] == pr[2:4]), t
        assert jr[4] == pr[4], (t, jr[4], pr[4])
        pobs_all.append(pr[0])
        infos.append(pr[4])
        if check_npcs:
            assert_npc_bits(jg._state.npc, pg.state.npc, f"step {t}")
        if jr[2] or jr[3]:
            break
    want = observe_all(jg._core, jg.states)
    if jg.traffic_flow:
        want = want[:, 0]
    assert_bits("obs", want, np.stack(pobs_all), "(axis 0 = step, the reset's first)")
    return steps, jg, pg, infos


def test_config1_episode_at_the_default_dt():
    steps, jg, pg, _ = run_episode(CONFIG1, [1.0 / 60.0] * 200)
    assert steps == 120                       # truncated at max_steps
    assert pg.env.step_count == jg.env.step_count == 120


def test_config1_episode_at_play_substeps():
    dts = substeps(60)
    assert len(set(dts)) > 20 and min(dts) < 1 / 60     # remainders as well as full ticks
    steps, _, _, _ = run_episode(CONFIG1, dts, seed=5)
    assert steps == min(len(dts), 120)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        GymIntersectionEnv({"backend": "jax", "device": "cpu"})
