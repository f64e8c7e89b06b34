"""Shared helpers of the tests that hold the PyTorch port against the JAX package.

Floats are compared by bit pattern. The JAX package's exact observation
(``exact_obs=True``) takes minutes to compile inside a jitted step on the
CPU, so the JAX side steps with ``with_obs=False`` under jit and builds all
observations of a run afterwards in one eager ``vmap(observe)`` over the
stacked states; ``observe`` is a pure function of the state, so these are
the observations the jitted step would have returned.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu import EnvConfig as JaxEnvConfig
from marl_traffic_intersection_tpu import IntersectionEnv as JaxEnv
from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, StepOutput

# The suite runs in several worker processes at once; torch's intra-op
# threads would spin on the cores the other workers need, and the port's
# test tensors are small.
torch.set_num_threads(1)


def bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits(name: str, expected, got, where="") -> None:
    e, g = bits(expected), bits(got)
    assert e.shape == g.shape, (name, where, e.shape, g.shape)
    bad = np.argwhere(e != g)
    if len(bad):
        i = tuple(bad[0])
        ev = np.asarray(expected.cpu() if torch.is_tensor(expected) else expected)[i]
        gv = np.asarray(got.cpu() if torch.is_tensor(got) else got)[i]
        raise AssertionError(f"{name} {where}: {len(bad)} elements differ, first at "
                             f"{i}: jax={ev!r} port={gv!r}")


def policy_random(rng, n):
    """The random policy of tests/test_env.py."""
    return np.stack([rng.choice([0.0, 0.5, 1.0, -0.5], n),
                     np.clip(rng.normal(0, 0.4, n), -1, 1)], axis=1).astype(np.float32)


def jax_env(num_agents, exact_obs=True, **kw) -> JaxEnv:
    return JaxEnv(JaxEnvConfig(num_agents=num_agents, exact_obs=exact_obs, **kw))


# XLA's algebraic simplifier rewrites a division by a constant into a
# multiply by the f32 reciprocal, which the reference does not do; the one
# such division left in the exact_obs chain is the physics' v / WHEELBASE
# (ROADMAP queue 3, H8). The exact chain is compiled without that pass.
EXACT_COMPILE = {"xla_disable_hlo_passes": "algsimp"}


def jax_stepper(jenv: JaxEnv, state, actions, exact: bool):
    """``jenv.step`` without the observation, compiled for these shapes (the
    reference chain when ``exact``)."""
    lowered = jax.jit(lambda s, a: jenv.step(s, a, with_obs=False)).lower(state, actions)
    return lowered.compile(compiler_options=EXACT_COMPILE if exact else None)


def _jax_reset_state(jvenv, seed: int):
    """The JAX VectorEnv's reset state, without its (eager, slow) observation."""
    keys = jax.random.split(jax.random.PRNGKey(seed), jvenv.num_envs)
    return jax.vmap(jvenv._reset_state_one)(keys)


def port_env(num_agents, **kw) -> IntersectionEnv:
    return IntersectionEnv(EnvConfig(num_agents=num_agents, **kw), device="cpu")


def observe_all(env: JaxEnv, states) -> np.ndarray:
    """Observations of a list of (batched) JAX states, in one eager call."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    fn = env.observe
    for _ in range(np.ndim(stacked.step_count)):
        fn = jax.vmap(fn)
    return np.asarray(fn(stacked))


_EGO_FLOATS = ("x", "y", "v", "heading", "steering_angle", "prev_dist_to_goal",
               "prev_acc_norm", "prev_steer_norm")


def compare_runs(jax_steps, port_steps, exact: bool, jenv=None, squeeze=False,
                 reset=None) -> None:
    """Hold a run of (state, out) pairs of the JAX package against the port's.

    Discrete state and lidar always, bit for bit; with ``exact`` also every
    float leaf, the reward and the observation (built for the JAX side by
    ``observe_all``). ``squeeze`` drops the port's env axis of size 1.
    ``reset`` = (JAX reset state, port reset obs) adds the reset observation.
    """
    def stack_j(get):
        return np.stack([np.asarray(get(s, o)) for s, o in jax_steps])

    def stack_p(get):
        a = np.stack([get(s, o).cpu().numpy() for s, o in port_steps])
        return a[:, 0] if squeeze else a

    fields = {
        "status": lambda s, o: o.status, "done": lambda s, o: o.done,
        "terminated": lambda s, o: o.terminated, "truncated": lambda s, o: o.truncated,
        "agents_alive": lambda s, o: o.agents_alive, "step": lambda s, o: o.step,
        "path_index": lambda s, o: s.ego.path_index, "route_id": lambda s, o: s.ego.route_id,
        "lidar": lambda s, o: s.lidar, "step_count": lambda s, o: s.step_count,
    }
    if exact:
        fields.update({f: (lambda s, o, f=f: getattr(s.ego, f)) for f in _EGO_FLOATS})
        fields["reward"] = lambda s, o: o.reward
    for name, get in fields.items():
        e, g = stack_j(get), stack_p(get)
        if name in ("terminated", "truncated") or e.dtype == bool:
            e, g = e.astype(bool), g.astype(bool)
        elif e.dtype != np.float32:
            e, g = e.astype(np.int64), g.astype(np.int64)
        assert_bits(name, e, g, "(axis 0 = step)")
    if exact:
        states = [s for s, _ in jax_steps]
        pobs = stack_p(lambda s, o: o.obs)
        if reset is not None:
            states.insert(0, reset[0])
            r = reset[1].cpu().numpy()
            pobs = np.concatenate([r if squeeze else r[None], pobs])
        assert_bits("obs", observe_all(jenv, states), pobs, "(axis 0 = step, reset first)")


def lockstep_single(routes, steps, *, exact_obs=True, seed=11, **cfg):
    """Step one JAX env and the port (B=1) with the same random actions.

    exact_obs=True: every leaf and output is held bit for bit. With the JAX
    default float chain (exact_obs=False) only discrete state and lidar are
    (its progress reward and obs round differently; ROADMAP queue 3, H3/H6).
    """
    n = len(routes)
    jenv = jax_env(n, exact_obs=exact_obs, **cfg)
    penv = port_env(n, **cfg)
    rid = jenv.table.route_ids(routes)
    js = jenv.reset_state(jax.random.PRNGKey(0), rid)
    jstep = jax_stepper(jenv, js, jnp.zeros((n, 2), jnp.float32), exact_obs)
    ps, pobs0 = penv.reset(rid)
    # the reset observation is step "-1" of the run
    jax_steps = [(js, None)]
    port_steps = [(ps, StepOutput(obs=pobs0, reward=None, done=None, status=None,
                                  terminated=None, truncated=None, agents_alive=None,
                                  step=None, spawned=None))]
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        a = policy_random(rng, n)
        js, jout = jstep(js, jnp.asarray(a))
        ps, pout = penv.step(ps, torch.from_numpy(a)[None])
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    compare_runs(jax_steps[1:], port_steps[1:], exact_obs, jenv, squeeze=True,
                 reset=(jax_steps[0][0], port_steps[0][1].obs))


@contextlib.contextmanager
def ieee_constant_division():
    """Trace with ``jnp.divide``'s divisor behind an optimization barrier, so
    XLA cannot turn a division by a constant into a multiply by its
    reciprocal (H8). The physics' ``v / WHEELBASE`` is the one ``jnp.divide``
    of the exact chain. This stands in for ``EXACT_COMPILE`` where compiling
    without algsimp crashes XLA-CPU: the traffic step, through the spawn's
    slot write (``npc_try_spawn``)."""
    divide = jnp.divide
    jnp.divide = lambda a, b: divide(a, jax.lax.optimization_barrier(jnp.asarray(b, a.dtype)))
    try:
        yield
    finally:
        jnp.divide = divide


def jax_spawn_stepper(jenv: JaxEnv, state, actions):
    """``jenv.step`` without the observation and with an injected spawn draw
    ``(do_try, route_choice)``, compiled for these shapes on the reference
    chain (``ieee_constant_division``)."""
    fn = lambda s, a, d, r: jenv.step(s, a, spawn=(d, r), with_obs=False)
    with ieee_constant_division():
        lowered = jax.jit(fn).lower(state, actions, jnp.asarray(False), jnp.int32(0))
    return lowered.compile()


def assert_npc_bits(jax_npc, port_npc, where="") -> None:
    """Every NpcState field bit for bit; the port's env axis is dropped when
    the JAX pool has none."""
    for f in port_npc._fields:
        e, g = np.asarray(getattr(jax_npc, f)), getattr(port_npc, f).cpu().numpy()
        if g.ndim > e.ndim:
            g = g[0]
        if e.dtype != np.float32:
            e, g = e.astype(np.int64), g.astype(np.int64)
        assert_bits(f"npc.{f}", e, g, where)


def lockstep_traffic(routes, steps, density, *, spawn_every=None, seed=0, num_lanes=3,
                     npc_mode="exact", throttle=None, **cfg):
    """Step one JAX traffic env and the port (B=1) with the same random
    actions and injected spawn draws: Bernoulli(1 - exp(-density/60)) or, with
    ``spawn_every``, also a forced try every that many steps. The NPC pool is
    held bit for bit every step, then the run as ``compare_runs`` does.
    Returns the number of steps with an alive NPC."""
    n = len(routes)
    kw = dict(num_lanes=num_lanes, traffic_flow=True, traffic_density=density,
              npc_mode=npc_mode, max_steps=4000, **cfg)
    jenv = jax_env(n, **kw)
    penv = port_env(n, **kw)
    rid = jenv.table.route_ids(routes)
    js = jenv.reset_state(jax.random.PRNGKey(seed), rid)
    jstep = jax_spawn_stepper(jenv, js, jnp.zeros((n, 2), jnp.float32))
    ps, pobs0 = penv.reset(rid)
    T = jenv.table.traffic_route_ids.shape[0]
    rng = np.random.RandomState(seed + 100)
    p_spawn = 1.0 - np.exp(-density / 60.0)
    jax_steps, port_steps, with_npcs = [], [], 0
    for t in range(steps):
        do_try = bool(rng.uniform() < p_spawn) or (spawn_every is not None
                                                   and t % spawn_every == 7)
        rc = int(rng.randint(T))
        a = policy_random(rng, n)
        if throttle is not None:        # drive straight on, clearing the spawn points
            a[:] = (throttle, 0.0)
        js, jout = jstep(js, jnp.asarray(a), jnp.asarray(do_try), jnp.int32(rc))
        ps, pout = penv.step(ps, torch.from_numpy(a)[None],
                             spawn=(torch.tensor([do_try]), torch.tensor([rc], dtype=torch.int32)))
        assert bool(jout.spawned) == bool(pout.spawned[0]), t
        assert_npc_bits(js.npc, ps.npc, f"step {t}")
        with_npcs += int(np.asarray(js.npc.alive).any())
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    compare_runs(jax_steps, port_steps, True, jenv, squeeze=True)
    return with_npcs


ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACTS = ROOT / "artifacts"
EXPORTS = ROOT / "marl_traffic_intersection_tpu_torch" / "artifacts"
EXPORT_GROUPS = ("params", "actor_params", "q_params")


def shipped_policies() -> list:
    """The names of the JAX package's shipped orbax artifacts."""
    return sorted(p.name for p in ARTIFACTS.glob("policy_*") if p.is_dir())


def export_leaves(checkpoint: dict) -> dict:
    """What an export holds of a restored checkpoint: each group of
    ``EXPORT_GROUPS`` it has, its flax collection level (``params``) dropped,
    as {path joined by '/': float32 array}."""
    out = {}
    for group in EXPORT_GROUPS:
        if group not in checkpoint:
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(checkpoint[group]["params"])[0]:
            key = "/".join([group] + [str(k.key) for k in path])
            out[key] = np.asarray(leaf, np.float32)
    return out


def export_policies(out_dir=EXPORTS) -> list:
    """Write one uncompressed ``.npz`` per shipped artifact into ``out_dir``,
    read through the JAX package's ``restore_checkpoint``; returns the paths."""
    from marl_traffic_intersection_tpu.utils.checkpoint import restore_checkpoint
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name in shipped_policies():
        leaves = export_leaves(restore_checkpoint(str(ARTIFACTS / name)))
        np.savez(out / f"{name}.npz", **leaves)
        written.append(out / f"{name}.npz")
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="helpers of the port's tests")
    ap.add_argument("command", choices=["export-policies"])
    ap.add_argument("--out", default=str(EXPORTS), help="directory of the .npz exports")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    for path in export_policies(args.out):
        print(path.relative_to(ROOT) if path.is_relative_to(ROOT) else path,
              path.stat().st_size, "bytes")
