"""The port's PPO learner against the JAX package's ``PPOLearner``.

Both sides get the same inputs, made with numpy from a seed, and parameters
made by flax's ``init`` (a 64-64 ``ActorCriticMLP``) carried over by
``convert.py``. Gradients and Adam moments come back into the port's layout
through the same converter.

Tolerances, each with its reason:
  * GAE: bit-equal to a numpy float32 recurrence that rounds every operation
    on its own, which is what the port computes; XLA-CPU may contract
    ``r + g * v' * (1 - d)`` into fused multiply-adds (ROADMAP queue 3, H3),
    so against JAX within ``GAE_TOL``.
  * the loss and its gradients in float32: the products and the reductions
    sum in another order, ``LOSS_F32`` (measured: loss 3.3e-7 relative,
    metrics 4.5e-6, gradients 8e-8 of max(1, their largest)); in bfloat16
    each layer's output may part by a bf16 ulp (tests/test_torch_mlp.py),
    ``LOSS_BF16`` (measured: gradients 4.9e-4 of max(1, their largest)).
  * one update (2 epochs x 2 minibatches of Adam), ``UPDATE_TOL``: in
    float32 the parameters agree within 1e-6 (measured 9e-8) and the
    moments within 1e-5 of their largest (measured 1.1e-6). In bfloat16 a
    gradient component near zero can take the other sign, and Adam, which
    divides by the root of the second moment, then moves its parameter by
    lr the other way: 4 steps at lr 3e-4 part two runs by at most
    2 x 4 x 3e-4 = 2.4e-3 (measured 6.4e-4); the moments, which follow the
    gradients, within 5% of their largest (measured 2.1%); the metrics within
    1% (measured 0.14%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marl_traffic_intersection_tpu.models.actor_critic import ActorCriticMLP as FlaxMLP
from marl_traffic_intersection_tpu.models.actor_critic import logp_and_entropy as jax_logp
from marl_traffic_intersection_tpu.parallel.ppo import PPOConfig as JaxPPOConfig
from marl_traffic_intersection_tpu.parallel.ppo import PPOLearner as JaxPPOLearner
from marl_traffic_intersection_tpu.parallel.ppo import TrainState as JaxTrainState
from marl_traffic_intersection_tpu.parallel.ppo import Transition as JaxTransition
import marl_traffic_intersection_tpu_torch.parallel.ppo as ppo_mod
from marl_traffic_intersection_tpu_torch import VectorEnv
from marl_traffic_intersection_tpu_torch.convert import mlp_params_from_flax
from marl_traffic_intersection_tpu_torch.models.actor_critic import (ActorCriticMLP,
                                                                     logp_and_entropy,
                                                                     sample_action)
from marl_traffic_intersection_tpu_torch.parallel.ppo import (PPOConfig, PPOLearner, Transition,
                                                              clip_by_global_norm_)

from ._torch_port import port_env

GAE_TOL = dict(rtol=2e-6, atol=2e-6)
LOSS_F32 = dict(rtol=1e-5, atol=1e-6)
LOSS_BF16 = dict(rtol=1e-3, atol=1e-3)
UPDATE_TOL = {"float32": dict(metric=1e-5, param=1e-6, moment=1e-5),
              "bfloat16": dict(metric=1e-2, param=2.4e-3, moment=5e-2)}
HIDDEN = (64, 64)


def _learner(cfg, dtype=torch.float32, **kw):
    venv = VectorEnv(port_env(2), num_envs=8, seed=0)
    return PPOLearner(venv, ActorCriticMLP(hidden=HIDDEN, compute_dtype=dtype), cfg, **kw)


def _flax(dtype="float32", seed=0):
    fm = FlaxMLP(hidden=HIDDEN, compute_dtype=getattr(jnp, dtype))
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 127)))
    return fm, params


def _port_model(params, dtype="float32"):
    return mlp_params_from_flax(jax.tree.map(np.asarray, params),
                                ActorCriticMLP(hidden=HIDDEN, compute_dtype=getattr(torch, dtype)))


def _as_port(tree, dtype="float32"):
    """A flax-layout tree (gradients, moments) as the port's named tensors."""
    return {k: v.detach() for k, v in _port_model(tree, dtype).named_parameters()}


def _gae_inputs(T=16, B=8, N=4, seed=0):
    rng = np.random.RandomState(seed)
    reward = rng.normal(0, 1, (T, B, N)).astype(np.float32)
    value = rng.normal(0, 2, (T, B, N)).astype(np.float32)
    last = rng.normal(0, 2, (B, N)).astype(np.float32)
    ep_done = rng.uniform(size=(T, B)) < 0.1
    agent_done = rng.uniform(size=(T, B, N)) < 0.15
    return reward, value, last, ep_done, agent_done


def _np_gae(reward, value, last, ep_done, agent_done, gamma=0.99, lam=0.95):
    """The float32 recurrence with every operation rounded on its own."""
    f = np.float32
    done = (ep_done[..., None] | agent_done).astype(f)
    advs = np.empty_like(reward)
    gae, nv = np.zeros_like(last), last
    for t in reversed(range(reward.shape[0])):
        nt = f(1) - done[t]
        delta = (reward[t] + (f(gamma) * nv) * nt) - value[t]
        gae = delta + (f(gamma * lam) * nt) * gae
        advs[t], nv = gae, value[t]
    return advs, advs + value


def _port_traj(reward, value, ep_done, agent_done, **more):
    t = lambda a: torch.from_numpy(np.array(a))
    shape = reward.shape
    fields = dict(obs=torch.zeros(shape + (127,)), raw_action=torch.zeros(shape + (2,)),
                  logp=torch.zeros(shape), value=t(value), reward=t(reward), ep_done=t(ep_done),
                  agent_done=t(agent_done), status=torch.zeros(shape, dtype=torch.int32))
    fields.update({k: t(v) for k, v in more.items()})
    return Transition(**fields)


def test_gae_bit_equal_to_the_separately_rounded_recurrence():
    reward, value, last, ep_done, agent_done = _gae_inputs()
    assert ep_done.any() and agent_done.any()
    advs, rets = _learner(PPOConfig())._gae(_port_traj(reward, value, ep_done, agent_done),
                                            torch.from_numpy(last))
    want_a, want_r = _np_gae(reward, value, last, ep_done, agent_done)
    np.testing.assert_array_equal(advs.numpy().view(np.int32), want_a.view(np.int32))
    np.testing.assert_array_equal(rets.numpy().view(np.int32), want_r.view(np.int32))


def test_gae_matches_jax():
    reward, value, last, ep_done, agent_done = _gae_inputs(seed=1)
    jl = JaxPPOLearner(None, None, JaxPPOConfig())
    z = np.zeros_like(reward)
    jtraj = JaxTransition(obs=None, raw_action=None, logp=z, value=value, reward=reward,
                          ep_done=ep_done, agent_done=agent_done, status=z.astype(np.int32))
    ja, jr = (np.asarray(a) for a in jax.jit(jl._gae)(jtraj, last))
    pa, pr = _learner(PPOConfig())._gae(_port_traj(reward, value, ep_done, agent_done),
                                        torch.from_numpy(last))
    np.testing.assert_allclose(pa.numpy(), ja, **GAE_TOL)
    np.testing.assert_allclose(pr.numpy(), jr, **GAE_TOL)


def _batch(fm, params, shape=(4, 8, 2), seed=0):
    """(obs, raw, old_logp, adv, ret, old_value) of a plausible rollout."""
    rng = np.random.RandomState(seed)
    obs = rng.uniform(-1, 1, shape + (127,)).astype(np.float32)
    mean, log_std, value = (np.asarray(a) for a in fm.apply(params, obs))
    raw = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    old_logp = (np.asarray(jax_logp(mean, log_std, raw)[0])
                + rng.normal(0, 0.05, shape)).astype(np.float32)
    adv = rng.normal(0.3, 1.5, shape).astype(np.float32)
    ret = (value + rng.normal(0, 0.5, shape)).astype(np.float32)
    old_value = (value + rng.normal(0, 0.3, shape)).astype(np.float32)
    return obs, raw, old_logp, adv, ret, old_value


@pytest.mark.parametrize("dtype,actor_on,shape", [
    ("float32", 1.0, (4, 8, 2)), ("float32", 0.0, (4, 8, 2)),
    ("bfloat16", 1.0, (4, 8, 2)), ("bfloat16", 0.0, (4, 8, 2)),
    ("float32", 1.0, (1, 2, 2))])
def test_loss_and_gradients_match_jax(dtype, actor_on, shape):
    fm, params = _flax(dtype)
    batch = _batch(fm, params, shape)
    jl = JaxPPOLearner(None, fm, JaxPPOConfig())
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jl._loss, has_aux=True))(params, batch, actor_on)
    model = _port_model(params, dtype)
    loss, m = _learner(PPOConfig())._loss(model, tuple(map(torch.from_numpy, batch)), actor_on)
    loss.backward()
    tol = LOSS_F32 if dtype == "float32" else LOSS_BF16
    np.testing.assert_allclose(loss.item(), float(jloss), **tol)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **tol, err_msg=k)
    want = _as_port(jg, dtype)
    for name, p in model.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, np.abs(g).max()), err_msg=name)
    if shape == (1, 2, 2):
        # four advantages: the unbiased std would move the loss far beyond the tolerance
        adv = torch.from_numpy(batch[3])
        ratio = torch.exp(logp_and_entropy(*model(torch.from_numpy(batch[0]))[:2],
                                           torch.from_numpy(batch[1]))[0]
                          - torch.from_numpy(batch[2]))
        pg = [-(torch.minimum(ratio * a_n, ratio.clamp(0.8, 1.2) * a_n)).mean().item()
              for a_n in ((adv - adv.mean()) / (adv.std(correction=c) + 1e-8) for c in (0, 1))]
        assert abs(pg[1] - float(jm["pg_loss"])) > 100 * LOSS_F32["atol"]
        np.testing.assert_allclose(pg[0], float(jm["pg_loss"]), **LOSS_F32)


@pytest.mark.parametrize("max_norm", [1e-2, 1e6])
def test_clip_by_global_norm_is_optax(max_norm):
    rng = np.random.RandomState(0)
    grads = [rng.normal(0, 0.1, s).astype(np.float32) for s in ((64, 127), (64,), (2,))]
    want = optax.clip_by_global_norm(max_norm).update(grads, None)[0]
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, max_norm)
    assert (float(norm) < max_norm) == (max_norm == 1e6)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
        if max_norm == 1e6:
            np.testing.assert_array_equal(g.numpy(), orig)       # below the norm: untouched


@pytest.mark.parametrize("dtype,max_grad_norm", [("float32", 100.0), ("float32", 1e-3),
                                                   ("bfloat16", 0.5)])
def test_update_replays_jax(dtype, max_grad_norm, monkeypatch):
    """2 epochs x 2 minibatches over T=4, the permutations computed from
    JAX's key splits (parallel/ppo.py:165-166) and fed to the port. The
    gradients' norms are ~1: the clip acts on every minibatch at 1e-3 and on
    none at 100."""
    T, B, N = 4, 8, 2
    jcfg = JaxPPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2,
                        max_grad_norm=max_grad_norm)
    fm, params = _flax(dtype)
    obs, raw, old_logp, adv, ret, old_value = _batch(fm, params, (T, B, N), seed=3)
    jl = JaxPPOLearner(None, fm, jcfg)
    key = jax.random.PRNGKey(11)
    perms, k = [], key
    for _ in range(jcfg.update_epochs):
        k, kp = jax.random.split(k)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, T))))
    z = np.zeros((T, B, N), np.float32)
    jtraj = JaxTransition(obs=obs, raw_action=raw, logp=old_logp, value=old_value, reward=z,
                          ep_done=np.zeros((T, B), bool), agent_done=z.astype(bool),
                          status=z.astype(np.int32))
    jts = JaxTrainState(params, jl.tx.init(params), jnp.int32(0))
    jts, jm = jax.jit(jl._update)(jts, jtraj, adv, ret, key)

    cfg = PPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2, max_grad_norm=max_grad_norm)
    learner = _learner(cfg, getattr(torch, dtype), perm_fn=lambda n: perms.pop(0))
    ts = learner.init()
    ts.model.load_state_dict(_port_model(params).state_dict())
    norms = []

    def spy(grads, m):
        norms.append(float(clip_by_global_norm_(grads, m)))

    monkeypatch.setattr(ppo_mod, "clip_by_global_norm_", spy)
    traj = _port_traj(z, old_value, np.zeros((T, B), bool), z.astype(bool), obs=obs,
                      raw_action=raw, logp=old_logp)
    ts, m = learner.update(ts, traj, torch.from_numpy(adv), torch.from_numpy(ret))
    assert not perms and ts.update_count == int(jts.update_count) == 4
    assert len(norms) == 4 and all((n > max_grad_norm) == (max_grad_norm < 1) for n in norms)
    tol = UPDATE_TOL[dtype]
    for k_ in jm:
        np.testing.assert_allclose(m[k_].item(), float(jm[k_]), rtol=tol["metric"],
                                   atol=tol["metric"] * 0.1, err_msg=k_)
    adam = jts.opt_state[1][0]
    want_p, want_mu, want_nu = (_as_port(t) for t in (jts.params, adam.mu, adam.nu))
    for name, p in ts.model.named_parameters():
        st = ts.optimizer.state[p]
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), rtol=0,
                                   atol=tol["param"], err_msg=name)
        for got, want in ((st["exp_avg"], want_mu[name]), (st["exp_avg_sq"], want_nu[name])):
            w = want.numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=tol["moment"] * np.abs(w).max(), err_msg=name)
        assert int(st["step"]) == int(adam.count) == 4


def test_rollout_is_a_hand_loop_of_vector_env_steps():
    """8 envs x 2 agents x T=8 with injected noise: the Transition equals a
    loop of policy forward, sample_action and VectorEnv.step with the same
    noise and the same route draws, bit for bit."""
    T = 8
    rng = np.random.RandomState(5)
    noise = [torch.from_numpy(rng.normal(size=(8, 2, 2)).astype(np.float32)) for _ in range(T)]
    queue = list(noise)
    cfg = PPOConfig(rollout_len=T)
    learner = _learner(cfg, noise_fn=lambda shape: queue.pop(0))
    ts = learner.init()
    state, obs = learner.env.reset()
    _, obs_end, traj, last_value = learner.rollout(ts, state, obs)

    venv = VectorEnv(port_env(2), num_envs=8, seed=0)
    s, o = venv.reset()
    with torch.no_grad():
        for t in range(T):
            mean, log_std, value = ts.model(o)
            action, raw = sample_action(mean, log_std, noise[t])
            want = dict(obs=o, raw_action=raw, value=value)
            s, out = venv.step(s, action)
            want.update(reward=out.reward, ep_done=out.terminated | out.truncated,
                        agent_done=out.done, status=out.status)
            for k, v in want.items():
                assert torch.equal(getattr(traj, k)[t], v), (k, t)
            o = out.obs
            logp = logp_and_entropy(*ts.model(traj.obs[t])[:2], traj.raw_action[t])[0]
            assert torch.equal(traj.logp[t], logp), t
        assert torch.equal(obs_end, o) and torch.equal(last_value, ts.model(o)[2])


def test_train_step_reports_finite_metrics_on_the_device():
    cfg = PPOConfig(rollout_len=8, update_epochs=2, num_minibatches=2)
    learner = _learner(cfg)
    ts = learner.init()
    state, obs = learner.env.reset()
    ts, state, obs, m = learner.train_step(ts, state, obs)
    assert set(m) == {"pg_loss", "v_loss", "entropy", "approx_kl", "mean_reward", "mean_value",
                      "success_rate", "crash_rate"}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in m.values())
    assert ts.update_count == 4 and obs.shape == (8, 2, 127)
