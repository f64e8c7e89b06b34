"""The SAC networks, replay ring, learner and train_sac entry point against
the JAX package's.

Parameters are made by flax's ``init`` (32-32 torsos) and carried over by
``convert.py``; the sample indices and the normal draws of one JAX update are
computed from its key splits (parallel/sac.py:150-157) and fed to the port.

Tolerances, each with its reason: ``sample_squashed``'s action within 2 f32
ulps of ``|mean| + |std * noise|`` (XLA may fuse ``mean + std * noise`` into
one rounding), its log-prob within 2 f32 ulps plus 1e-5. One update in float32: losses and
metrics within 1e-5 relative (the products sum in another order), parameters
within 1e-6 (one Adam step moves a parameter by about lr = 3e-4). In
bfloat16 a gradient component near zero can take the other sign, and Adam
then moves its parameter by lr the other way: parameters within 2 x lr =
6e-4, the targets within tau times that, the losses within 1%.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu import EnvConfig as JaxEnvConfig
from marl_traffic_intersection_tpu import IntersectionEnv as JaxEnv
from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu.models.sac import QCritic as FlaxQ
from marl_traffic_intersection_tpu.models.sac import SquashedGaussianActor as FlaxActor
from marl_traffic_intersection_tpu.models.sac import sample_squashed as jax_sample_squashed
from marl_traffic_intersection_tpu.parallel.sac import SACConfig as JaxSACConfig
from marl_traffic_intersection_tpu.parallel.sac import SACLearner as JaxSACLearner
from marl_traffic_intersection_tpu_torch import VectorEnv, train_sac
from marl_traffic_intersection_tpu_torch.convert import (sac_actor_params_from_flax,
                                                         sac_critic_params_from_flax)
from marl_traffic_intersection_tpu_torch.models.sac import (SquashedGaussianActor, TwinQCritic,
                                                            sample_squashed)
from marl_traffic_intersection_tpu_torch.parallel.sac import SACConfig, SACLearner
from marl_traffic_intersection_tpu_torch.utils.checkpoint import (EXPORTS, read_export,
                                                                  restore_checkpoint)

from ._torch_port import port_env

HIDDEN = (32, 32)
UPDATE_TOL = {"float32": dict(metric=1e-5, param=1e-6),
              "bfloat16": dict(metric=1e-2, param=6e-4)}


def test_sample_squashed_matches_jax_on_its_draws():
    rng = np.random.RandomState(0)
    mean = rng.uniform(-3, 3, (512, 2)).astype(np.float32)
    log_std = rng.uniform(-5, 2, (512, 2)).astype(np.float32)
    log_std[:64], log_std[64:128] = -5.0, 2.0           # the clip's bounds
    key = jax.random.PRNGKey(4)
    ja, jl = (np.asarray(a) for a in jax.jit(jax_sample_squashed)(key, mean, log_std))
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    pa, pl = (a.numpy() for a in sample_squashed(*map(torch.from_numpy, (mean, log_std, noise))))
    # a fused multiply-add skips the product's rounding: up to one f32 ulp of
    # |std * noise| (std reaches e^2 here), which tanh passes on near 0
    ulp = 2.4e-7 * (np.abs(mean) + np.exp(log_std) * np.abs(noise))
    assert (np.abs(pa - ja) <= ulp + 1e-7).all(), np.abs(pa - ja).max()
    np.testing.assert_allclose(pl, jl, rtol=2.4e-7, atol=1e-5)
    assert np.isfinite(pl).all() and np.abs(pa).max() <= 1.0


def _learner(num_envs=4, agents=2, dtype=torch.float32, **cfg):
    venv = VectorEnv(port_env(agents, max_steps=64), num_envs=num_envs, seed=1)
    defaults = dict(buffer_capacity=64, warmup=16, batch_size=8, steps_per_call=2)
    defaults.update(cfg)
    return SACLearner(venv, SACConfig(**defaults),
                      SquashedGaussianActor(hidden=HIDDEN, compute_dtype=dtype),
                      TwinQCritic(hidden=HIDDEN, compute_dtype=dtype))


@pytest.mark.parametrize("capacity,want", [(16, 16), (20, 24), (3, 8)])
def test_ring_wraps_around_and_rounds_its_capacity(capacity, want):
    ln = _learner(buffer_capacity=capacity)          # chunk = 4 envs x 2 agents = 8
    assert ln.chunk == 8 and ln.capacity == want
    ts = ln.init()
    buf = ts.buffer
    n = want // 8
    for v in range(1, n + 2):                        # the last insert overwrites slot 0
        ln._insert(buf, torch.full((8, 127), float(v)), torch.full((8, 2), float(v)),
                   torch.full((8,), float(v)), torch.full((8, 127), float(v)), torch.zeros(8))
    assert int(buf.size) == want and buf.ptr == 1 % n
    assert torch.equal(buf.reward[:8], torch.full((8,), float(n + 1)))
    if n > 1:
        assert torch.equal(buf.reward[8:16], torch.full((8,), 2.0))


def test_warmup_gates_the_updates_while_adam_counts_its_steps():
    ln = _learner(warmup=10 ** 6, steps_per_call=3)
    ts = ln.init()
    before = [p.detach().clone() for m in (ts.actor, ts.critic, ts.critic_target)
              for p in m.parameters()] + [ts.log_alpha.detach().clone()]
    state, obs = ln.env.reset()
    ts, state, obs, m = ln.train_step(ts, state, obs)
    after = [p for m_ in (ts.actor, ts.critic, ts.critic_target) for p in m_.parameters()]
    for a, b in zip(before, after + [ts.log_alpha]):
        assert torch.equal(a, b.detach())
    assert ts.update_count == 3 and int(ts.buffer.size) == 3 * 8
    for opt in (ts.actor_opt, ts.q_opt, ts.alpha_opt):
        assert all(int(st["step"]) == 3 for st in opt.state.values()) and len(opt.state) > 0
    assert all(torch.isfinite(v) for v in m.values())


def _jax_pair(dtype):
    jenv = JaxEnv(JaxEnvConfig(num_agents=2, max_steps=64))
    jl = JaxSACLearner(JaxVectorEnv(jenv, num_envs=4),
                       JaxSACConfig(buffer_capacity=64, warmup=16, batch_size=32),
                       actor=FlaxActor(hidden=HIDDEN, compute_dtype=getattr(jnp, dtype)),
                       critic=FlaxQ(hidden=HIDDEN, compute_dtype=getattr(jnp, dtype)))
    ts = jl.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    C = jl.capacity
    buf = ts.buffer._replace(
        obs=rng.uniform(-1, 1, (C, 127)).astype(np.float32),
        action=rng.uniform(-1, 1, (C, 2)).astype(np.float32),
        reward=rng.normal(0, 1, C).astype(np.float32),
        next_obs=rng.uniform(-1, 1, (C, 127)).astype(np.float32),
        done=(rng.uniform(size=C) < 0.2).astype(np.float32), ptr=jnp.int32(6),
        size=jnp.int32(48))
    # targets apart from the critics, so that the polyak step shows
    q_target = jax.tree.map(lambda x: x + np.float32(0.05) * rng.normal(size=x.shape)
                            .astype(np.float32), ts.q_params)
    return jl, ts._replace(buffer=buf, q_target=q_target)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_replays_jax(dtype):
    jl, jts = _jax_pair(dtype)
    key = jax.random.PRNGKey(7)
    ks, ka, kt = jax.random.split(key, 3)
    idx = np.array(jax.random.randint(ks, (32,), 0, 48))
    draws = [np.array(jax.random.normal(k, (32, 2), jnp.float32)) for k in (kt, ka)]
    jts2, jm = jax.jit(jl._update)(jts, key)

    tdt = getattr(torch, dtype)
    queue = [torch.from_numpy(d) for d in draws]       # the target's draw, then the actor's
    ln = SACLearner(VectorEnv(port_env(2, max_steps=64), num_envs=4, seed=1),
                    SACConfig(buffer_capacity=64, warmup=16, batch_size=32),
                    SquashedGaussianActor(hidden=HIDDEN, compute_dtype=tdt),
                    TwinQCritic(hidden=HIDDEN, compute_dtype=tdt),
                    noise_fn=lambda shape: queue.pop(0),
                    index_fn=lambda n, size: torch.from_numpy(idx))
    tree = lambda t: jax.tree.map(np.asarray, t)
    sac_actor_params_from_flax(tree(jts.actor_params), ln.actor)
    sac_critic_params_from_flax(tree(jts.q_params), ln.critic)
    ts = ln.init()
    sac_critic_params_from_flax(tree(jts.q_target), ts.critic_target)
    assert float(ts.log_alpha.detach()) == float(jts.log_alpha)
    b = jts.buffer
    for name in ("obs", "action", "reward", "next_obs", "done"):
        getattr(ts.buffer, name).copy_(torch.from_numpy(np.asarray(getattr(b, name))))
    ts.buffer.size.fill_(int(b.size))
    m = ln._update(ts)
    assert not queue and ts.update_count == 1

    tol = UPDATE_TOL[dtype]
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=tol["metric"],
                                   atol=tol["metric"] * 0.1, err_msg=k)
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(jts2.log_alpha), rtol=0,
                               atol=tol["param"])
    want = {"actor": sac_actor_params_from_flax(tree(jts2.actor_params),
                                                SquashedGaussianActor(hidden=HIDDEN)),
            "critic": sac_critic_params_from_flax(tree(jts2.q_params), TwinQCritic(hidden=HIDDEN)),
            "critic_target": sac_critic_params_from_flax(tree(jts2.q_target),
                                                         TwinQCritic(hidden=HIDDEN))}
    before = sac_actor_params_from_flax(tree(jts.actor_params),
                                        SquashedGaussianActor(hidden=HIDDEN))
    moved = max(float((p - q).detach().abs().max())
                for p, q in zip(want["actor"].parameters(), before.parameters()))
    assert moved > 10 * tol["param"] or dtype == "bfloat16"
    for name, w in want.items():
        got = dict(getattr(ts, name).named_parameters())
        for k, v in w.named_parameters():
            np.testing.assert_allclose(got[k].detach().numpy(), v.detach().numpy(), rtol=0,
                                       atol=tol["param"], err_msg=f"{name}.{k}")
    for opt in (ts.actor_opt, ts.q_opt, ts.alpha_opt):
        assert all(int(st["step"]) == 1 for st in opt.state.values())


def test_collect_seeds_the_ring_without_updates():
    ln = _learner(buffer_capacity=128)
    ts = ln.init()
    state, obs = ln.env.reset()
    gen = torch.Generator().manual_seed(0)
    policy = lambda o: torch.tanh(torch.randn(o.shape[:-1] + (2,), generator=gen))
    ts, state, obs = ln.collect(ts, state, obs, policy, steps=3)
    assert int(ts.buffer.size) == 3 * ln.chunk and ts.update_count == 0
    assert ts.buffer.obs[:ln.chunk].abs().sum() > 0 and ts.buffer.ptr == 3
    seeded = int(ts.buffer.size)
    ts, *_ = ln.train_step(ts, state, obs)
    assert int(ts.buffer.size) == seeded + 2 * ln.chunk and ts.update_count == 2


SMALL = ["--device", "cpu", "--num-envs", "4", "--agents", "2", "--steps-per-call", "2",
         "--capacity", "64", "--batch-size", "8", "--warmup", "16"]


def _run(capsys, *args):
    train_sac.main(SMALL + [str(a) for a in args])
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_train_sac_demo_checkpoint_and_resume(tmp_path, capsys):
    lines = _run(capsys, "--calls", 3, "--demo", "artifacts/policy_mlp_multi", "--demo-steps", 2,
                 "--checkpoint", tmp_path / "a")
    assert lines[0] == {"demo_transitions": 16, "secs": lines[0]["secs"]}
    logs = lines[1:]
    assert [ln["call"] for ln in logs] == [0, 2] and logs[-1]["updates"] == 6
    keys = ("q_loss", "actor_loss", "alpha", "mean_q", "entropy", "buffer_size", "mean_reward")
    assert all(np.isfinite([ln[k] for k in keys]).all() and ln["device"] == "cpu" for ln in logs)
    assert logs[-1]["buffer_size"] == 64.0
    # a resumed run starts from the saved actor and critics exactly
    _run(capsys, "--calls", 0, "--resume", tmp_path / "a", "--checkpoint", tmp_path / "b")
    a, b = restore_checkpoint(tmp_path / "a"), restore_checkpoint(tmp_path / "b")
    for part in ("actor_params", "q_params"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    # and from a shipped SAC export
    _run(capsys, "--calls", 1, "--resume", "policy_sac_multi", "--checkpoint", tmp_path / "c")
    c = restore_checkpoint(tmp_path / "c")
    export = read_export(EXPORTS / "policy_sac_multi.npz")["actor_params"]
    w0 = c["actor_params"]["torso.0.weight"].numpy()
    assert np.abs(w0 - export["torso_0"]["kernel"].T).max() < 1e-2
