"""The port's VectorEnv (CPU) against the JAX package's, with auto-reset.

64 envs x 4 agents x 300 steps, episodes truncated at 100 steps. The JAX
side draws the reset routes; they are replayed into the port through its
injectable route sampler (torch cannot reproduce jax.random streams). Every
leaf and output is bit-equal on the reference chain. The JAX VectorEnv's
observation is replaced by a stub inside the jitted step and rebuilt
afterwards from the merged states (see tests/_torch_port.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu_torch import VectorEnv

from ._torch_port import (EXACT_COMPILE, _jax_reset_state, assert_bits, compare_runs, jax_env,
                          port_env)

B, N, STEPS = 64, 4, 300


def _jax_vector(max_steps):
    jenv = jax_env(N, max_steps=max_steps)
    venv = JaxVectorEnv(jenv, num_envs=B)
    venv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    return jenv, venv


def test_vector_env_auto_reset_replayed_routes_bit_equal():
    jenv, jvenv = _jax_vector(max_steps=100)
    js = _jax_reset_state(jvenv, 0)
    acts0 = jnp.zeros((B, N, 2), jnp.float32)
    jstep = jax.jit(jvenv.step).lower(js, acts0).compile(compiler_options=EXACT_COMPILE)

    next_ids = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    pvenv = VectorEnv(port_env(N, max_steps=100), num_envs=B,
                      route_sampler=lambda k: next_ids["rid"][:k])
    ps, pobs0 = pvenv.reset()

    rng = np.random.RandomState(5)
    jax_steps, port_steps, resets = [], [], 0
    for _ in range(STEPS):
        a = np.stack([rng.uniform(-0.3, 1.0, (B, N)), rng.uniform(-1, 1, (B, N))],
                     -1).astype(np.float32)
        js, jout = jstep(js, jnp.asarray(a))
        next_ids["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pvenv.step(ps, torch.from_numpy(a))
        resets += int(np.asarray(jout.terminated | jout.truncated).sum())
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    assert resets >= B * 2           # every env reset at least twice
    compare_runs(jax_steps, port_steps, True, jenv,
                 reset=(_jax_reset_state(jvenv, 0), pobs0))


def test_vector_env_batch_independence():
    """Env 0 stepped alone equals env 0 stepped in a batch."""
    penv = port_env(1)
    venv = VectorEnv(penv, num_envs=3, auto_reset=False, seed=1)
    state, _ = venv.reset()
    acts = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (3, 1, 2)).astype(np.float32))
    s_all, out_all = venv.step(state, acts)
    single = type(state)(ego=type(state.ego)(*(t[:1] for t in state.ego)),
                         lidar=state.lidar[:1], step_count=state.step_count[:1])
    s_one, out_one = penv.step(single, acts[:1])
    assert_bits("obs", out_all.obs[:1], out_one.obs)
    assert_bits("x", s_all.ego.x[:1], s_one.ego.x)


def test_vector_env_final_obs_is_the_pre_reset_observation():
    penv = port_env(2, max_steps=5)
    venv = VectorEnv(penv, num_envs=4, seed=3)
    state, _ = venv.reset()
    acts = torch.zeros((4, 2, 2))
    for t in range(5):
        stepped, _ = penv.step(state, acts, with_obs=False)
        state, out, term_obs = venv.step(state, acts, final_obs=True)
    assert bool(out.truncated.all())
    assert (state.step_count == 0).all()
    assert_bits("final_obs", penv.observe(stepped), term_obs)
    assert out.obs.shape == (4, 2, 127)


def test_default_route_sampler_draws_without_replacement():
    venv = VectorEnv(port_env(4), num_envs=256, seed=0)
    rid = venv.sample_routes(256)
    assert rid.shape == (256, 4)
    assert all(len(set(row.tolist())) == 4 for row in rid)
    assert set(rid.unique().tolist()) <= set(venv.route_pool.tolist())


def test_env_state_converts_from_and_to_the_jax_leaves():
    """A lockstep can start from a JAX state: its leaves (numpy) become the
    port's state, which steps exactly like the port's own reset state, and
    convert back unchanged."""
    from marl_traffic_intersection_tpu_torch.convert import (env_state_from_numpy,
                                                             env_state_to_numpy)
    jenv = jax_env(4, exact_obs=False)
    js = _jax_reset_state(JaxVectorEnv(jenv, num_envs=8), 2)
    ego = {f: np.asarray(getattr(js.ego, f)) for f in js.ego._fields}
    ps = env_state_from_numpy(ego, js.lidar, js.step_count)
    back = env_state_to_numpy(ps)
    for f, a in ego.items():
        assert_bits(f, a, back["ego"][f])
    assert_bits("lidar", np.asarray(js.lidar), back["lidar"])

    penv = port_env(4)
    own = penv.reset_state(torch.from_numpy(ego["route_id"]))
    acts = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (8, 4, 2)).astype(np.float32))
    (s1, o1), (s2, o2) = penv.step(ps, acts), penv.step(own, acts)
    assert_bits("obs", o2.obs, o1.obs)
    assert_bits("x", s2.ego.x, s1.ego.x)

    one = env_state_from_numpy({f: a[0] for f, a in ego.items()}, np.asarray(js.lidar)[0],
                               np.asarray(js.step_count)[0], batched=False)
    assert one.ego.x.shape == (1, 4) and one.step_count.shape == (1,)
