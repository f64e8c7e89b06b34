"""The GRU family and its truncated-BPTT PPO learner against the JAX package's.

Parameters are made by flax's ``init`` and carried over by ``convert.py``;
gradients and Adam moments come back into the port's layout the same way.

Tolerances, each with its reason:
  * the forward over 32 steps with resets: float32 within ``F32_ATOL`` = 1e-5
    (the products sum in another order; measured 2.7e-7); bfloat16 within
    ``BF16_ATOL`` = 2^-6, two bf16 ulps of the hidden state's largest values
    (|h| < 1): flax rounds each product to bf16 before adding the bias, torch
    after, and the difference is carried from step to step in h (measured
    0.0093 in h, 0.0049 in the value, 4.6e-5 in the mean).
  * one update (2 epochs x 2 chunks of Adam): tests/test_torch_ppo.py's
    ``UPDATE_TOL``, for the same reasons.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.models import RecurrentActorCritic as FlaxGRU
from marl_traffic_intersection_tpu.parallel.ppo import PPOConfig as JaxPPOConfig
from marl_traffic_intersection_tpu.parallel.ppo import TrainState as JaxTrainState
from marl_traffic_intersection_tpu.parallel.recurrent_ppo import RecTransition as JaxRecTransition
from marl_traffic_intersection_tpu.parallel.recurrent_ppo import (
    RecurrentPPOLearner as JaxRecurrentPPOLearner)
from marl_traffic_intersection_tpu_torch import VectorEnv
from marl_traffic_intersection_tpu_torch.convert import gru_params_from_flax
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.models.actor_critic import logp_and_entropy
from marl_traffic_intersection_tpu_torch.models.recurrent import RecurrentActorCritic
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig
from marl_traffic_intersection_tpu_torch.parallel.recurrent_ppo import (RecTransition,
                                                                        RecurrentPPOLearner)
from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint

from ._torch_port import port_env
from .test_torch_ppo import UPDATE_TOL
from .test_torch_train import TIMING, _run

F32_ATOL = 1e-5
BF16_ATOL = 2.0 ** -6
SMALL = dict(hidden=64, gru=32)


def _flax(dtype="float32", seed=0, **kw):
    fm = FlaxGRU(compute_dtype=getattr(jnp, dtype), **kw)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 127)), fm.initial_hidden(1))
    return fm, params


def _port(params, dtype="float32", **kw):
    return gru_params_from_flax(jax.tree.map(np.asarray, params),
                                RecurrentActorCritic(compute_dtype=getattr(torch, dtype), **kw))


def _as_port(tree, **kw):
    return {k: v.detach() for k, v in _port(tree, **kw).named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_forward_over_a_sequence_with_resets_matches_flax(dtype):
    fm, params = _flax(dtype, seed=3)
    model = _port(params, dtype)
    rng = np.random.RandomState(0)
    T, B = 32, 24
    obs = rng.uniform(-1, 1, (T, B, 127)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.15
    assert done.any()
    apply = jax.jit(fm.apply)
    jh, th = fm.initial_hidden(B), model.initial_hidden(B)
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for t in range(T):
        jm, jl, jv, jh2 = apply(params, obs[t], jh)
        with torch.no_grad():
            tm, tl, tv, th2 = model(torch.from_numpy(obs[t]), th)
        for name, w, g in (("mean", jm, tm), ("value", jv, tv), ("h", jh2, th2)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol,
                                       err_msg=f"{name} at step {t}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
        jh = jh2 * (1.0 - done[t].astype(np.float32))[:, None]
        th = th2 * (1.0 - torch.from_numpy(done[t]).float())[:, None]


def test_gru_parameter_count_and_make_model():
    fm = FlaxGRU()
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.zeros((1, 127)),
                            fm.initial_hidden(1))
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    a, b = make_model("gru", seed=4), make_model("gru", seed=4)
    assert sum(p.numel() for p in a.parameters()) == n_flax == 181_125
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def _learner(cfg, num_envs=4, agents=2, max_steps=32, **kw):
    venv = VectorEnv(port_env(agents, max_steps=max_steps), num_envs=num_envs, seed=1)
    return RecurrentPPOLearner(venv, RecurrentActorCritic(compute_dtype=torch.float32, **SMALL),
                               cfg, **kw)


def test_chunk_replay_reproduces_the_rollout():
    """The loss's replay of each chunk from its stored entry hidden state
    gives the rollout's log-probs and values bit for bit (same parameters)."""
    learner = _learner(PPOConfig(rollout_len=8, num_minibatches=2, update_epochs=1),
                       max_steps=5)
    ts = learner.init()
    state, obs = learner.env.reset()
    _, _, _, traj, _ = learner.rollout(ts, state, obs, learner.initial_hidden())
    assert traj.done.any()
    learner.perm_fn = lambda n: torch.arange(n)
    advs = rets = torch.zeros_like(traj.value)
    batches = (learner._minibatch(traj, advs, rets, idx) for idx in learner._minibatch_indices())
    for c, (o, h0, done, raw, *_) in enumerate(batches):
        h = h0
        with torch.no_grad():
            for t in range(o.shape[0]):
                mean, log_std, value, h2 = ts.model(o[t], h)
                i = 4 * c + t
                assert torch.equal(logp_and_entropy(mean, log_std, raw[t])[0], traj.logp[i]), i
                assert torch.equal(value, traj.value[i]), i
                h = h2 * (1.0 - done[t].float())[..., None]
                if t + 1 < o.shape[0]:
                    assert torch.equal(h, traj.h_in[i + 1]), i


def test_hidden_state_resets_at_done():
    """max_steps=3: every env truncates at steps 3 and 6; the hidden state
    entering the step after a truncation is zero, and nonzero elsewhere."""
    learner = _learner(PPOConfig(rollout_len=6, num_minibatches=2, update_epochs=1),
                       num_envs=2, agents=1, max_steps=3)
    ts = learner.init()
    state, obs = learner.env.reset()
    _, _, h_end, traj, _ = learner.rollout(ts, state, obs, learner.initial_hidden())
    assert traj.done[2].all() and traj.done[5].all()
    assert not traj.h_in[3].any() and not h_end.any()
    assert traj.h_in[1].abs().sum() > 0 and traj.h_in[4].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_replays_jax(dtype):
    """2 epochs x 2 chunks over T=8, the chunk orders computed from JAX's key
    splits (recurrent_ppo.py:133-134) and fed to the port."""
    T, B, N, H = 8, 4, 2, SMALL["gru"]
    fm, params = _flax(dtype, **SMALL)
    rng = np.random.RandomState(5)
    obs = rng.uniform(-1, 1, (T, B, N, 127)).astype(np.float32)
    h_in = rng.uniform(-0.5, 0.5, (T, B, N, H)).astype(np.float32)
    done = rng.uniform(size=(T, B, N)) < 0.2
    raw = rng.normal(0, 0.5, (T, B, N, 2)).astype(np.float32)
    old_logp = rng.normal(-2, 0.3, (T, B, N)).astype(np.float32)
    old_value = rng.normal(0, 0.5, (T, B, N)).astype(np.float32)
    adv = rng.normal(0.3, 1.5, (T, B, N)).astype(np.float32)
    ret = (old_value + rng.normal(0, 0.5, (T, B, N))).astype(np.float32)
    jcfg = JaxPPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2)
    jl = JaxRecurrentPPOLearner(None, fm, jcfg)
    key = jax.random.PRNGKey(11)
    perms, k = [], key
    for _ in range(jcfg.update_epochs):
        k, kp = jax.random.split(k)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, 2))))
    z = np.zeros((T, B, N), np.float32)
    jtraj = JaxRecTransition(obs=obs, h_in=h_in, raw_action=raw, logp=old_logp, value=old_value,
                             reward=z, ep_done=np.zeros((T, B), bool), agent_done=done,
                             done=done, status=z.astype(np.int32))
    jts = JaxTrainState(params, jl.tx.init(params), jnp.int32(0))
    jts, jm = jax.jit(jl._update)(jts, jtraj, adv, ret, key)

    cfg = PPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2)
    learner = _learner(cfg, perm_fn=lambda n: perms.pop(0))
    learner.model = _port(params, dtype, **SMALL)
    ts = learner.init()
    t = lambda a: torch.from_numpy(np.array(a))
    ptraj = RecTransition(obs=t(obs), h_in=t(h_in), raw_action=t(raw), logp=t(old_logp),
                          value=t(old_value), reward=t(z), ep_done=t(np.zeros((T, B), bool)),
                          agent_done=t(done), done=t(done), status=t(z.astype(np.int32)))
    ts, m = learner.update(ts, ptraj, t(adv), t(ret))
    assert not perms and ts.update_count == int(jts.update_count) == 4
    tol = UPDATE_TOL[dtype]
    for k_ in jm:
        np.testing.assert_allclose(m[k_].item(), float(jm[k_]), rtol=tol["metric"],
                                   atol=tol["metric"] * 0.1, err_msg=k_)
    adam = jts.opt_state[1][0]
    want_p, want_mu, want_nu = (_as_port(x, **SMALL) for x in (jts.params, adam.mu, adam.nu))
    for name, p in ts.model.named_parameters():
        st = ts.optimizer.state[p]
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), rtol=0,
                                   atol=tol["param"], err_msg=name)
        for got, want in ((st["exp_avg"], want_mu[name]), (st["exp_avg_sq"], want_nu[name])):
            w = want.numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=tol["moment"] * np.abs(w).max(), err_msg=name)
        assert int(st["step"]) == int(adam.count) == 4


def test_train_gru_runs_and_resumes_exactly(tmp_path, capsys):
    """train --model gru: 4 updates in one run equal 2 updates plus 2 after
    an auto-resume, bit for bit on every logged metric, the model, Adam's
    state and the carried hidden state."""
    whole = _run(capsys, "--updates", 4, "--model", "gru", "--checkpoint", tmp_path / "a")
    first = _run(capsys, "--updates", 2, "--model", "gru", "--checkpoint", tmp_path / "b")
    rest = _run(capsys, "--updates", 4, "--model", "gru", "--checkpoint", tmp_path / "b")
    assert sorted(first) == [0, 1] and sorted(rest) == [2, 3]
    for u, line in {**first, **rest}.items():
        assert {k: v for k, v in line.items() if k not in TIMING} == \
               {k: v for k, v in whole[u].items() if k not in TIMING}, u
        assert np.isfinite([line[k] for k in ("pg_loss", "v_loss", "approx_kl")]).all()
    a, b = restore_checkpoint(tmp_path / "a"), restore_checkpoint(tmp_path / "b")
    assert a["h"].shape == (4, 2, 128) and a["h"].abs().sum() > 0
    assert torch.equal(a["h"], b["h"]) and torch.equal(a["obs"], b["obs"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
