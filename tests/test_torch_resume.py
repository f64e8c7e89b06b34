"""Fine-tunes and warm starts from the shipped policies: the port's
``load_train_state``, ``train --resume <store>`` and ``warm_start_central``
against the JAX package's orbax stores and learners.

Tolerances: the restored Adam state is held bit for bit against the store.
One resumed update (2 epochs x 2 minibatches) is held to
tests/test_torch_ppo.py's ``UPDATE_TOL`` in float32, for the reasons given
there: the products and reductions sum in another order.

The resumed mlp update runs on config-1 observations, as the store was
trained on. In policy_mlp_cfg1, 7.9% of the first layer's weights read
observation features that config 1 never sets (the neighbour slots), and
their Adam second moment is exactly 0. A first nonzero gradient g there moves
the weight by lr * 0.1 g / (sqrt(0.001 g^2) + 1e-8): about 3.16 lr in the
sign of g, whatever its size. So on observations that set those features
(uniform noise, say) the two sides' summation orders decide steps of up to
1e-3 where g is within rounding of 0 (measured: 4 weights past 1e-6, the
largest 1.7e-5 off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.models import ActorCriticMLP as FlaxMLP
from marl_traffic_intersection_tpu.models import RecurrentActorCritic as FlaxGRU
from marl_traffic_intersection_tpu.models.actor_critic import logp_and_entropy as jax_logp
from marl_traffic_intersection_tpu.parallel.ppo import PPOConfig as JaxPPOConfig
from marl_traffic_intersection_tpu.parallel.ppo import PPOLearner as JaxPPOLearner
from marl_traffic_intersection_tpu.parallel.ppo import TrainState as JaxTrainState
from marl_traffic_intersection_tpu.parallel.ppo import Transition as JaxTransition
from marl_traffic_intersection_tpu.parallel.recurrent_ppo import RecTransition as JaxRecTransition
from marl_traffic_intersection_tpu.parallel.recurrent_ppo import (
    RecurrentPPOLearner as JaxRecurrentPPOLearner)
from marl_traffic_intersection_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from marl_traffic_intersection_tpu_torch import VectorEnv, warm_start_central
from marl_traffic_intersection_tpu_torch.convert import params_from_flax
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.parallel import ppo as ppo_mod
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner, TrainState
from marl_traffic_intersection_tpu_torch.parallel.recurrent_ppo import (RecTransition,
                                                                        RecurrentPPOLearner)
from marl_traffic_intersection_tpu_torch.utils.checkpoint import (load_policy, load_train_state,
                                                                  restore_checkpoint)

from ._torch_port import ARTIFACTS, port_env
from .test_torch_ppo import UPDATE_TOL, _port_traj
from .test_torch_train import _run

STORES = {"mlp": "policy_mlp_cfg1", "conv": "policy_conv_cfg1", "attention": "policy_attn_cfg1",
          "central": "policy_central_multi", "gru": "policy_gru_cfg1"}
F32 = dict(compute_dtype=torch.float32)


def _store(name):
    return jax_restore(str(ARTIFACTS / name))


def _port_layout(kind, tree):
    """A flax-layout tree (moments) as the port's named tensors, through the
    family's converter."""
    return {k: v.detach() for k, v in params_from_flax(kind, tree).named_parameters()}


def _bits(t):
    return t.detach().numpy().view(np.int32)


# the layout of one moment per family, spelled out: (port name, flax path, transform)
SPOT = {"mlp": ("torso.0.weight", ("torso_0", "kernel"), lambda a: a.T),
        "conv": ("ray_conv.0.weight", ("ray_conv_0", "kernel"), lambda a: a.transpose(2, 1, 0)),
        "attention": ("blocks.0.attn.query.weight",
                      ("block_0", "MultiHeadDotProductAttention_0", "query", "kernel"),
                      lambda a: a.reshape(a.shape[0], -1).T),
        "central": ("critic_embed.weight", ("critic_embed", "kernel"), lambda a: a.T),
        "gru": ("gru.w_ih", ("gru", "iz", "kernel"), lambda a: a.T)}


@pytest.mark.parametrize("kind", sorted(STORES))
def test_restored_moments_are_the_stores(kind):
    """exp_avg, exp_avg_sq and step are optax's mu, nu and count, bit for bit,
    in the converter's layout; the model holds the store's weights."""
    name = STORES[kind]
    store = _store(name)
    adam = store["opt_state"][1][0]
    st = load_train_state(name, kind)
    assert st.update == int(store["update"]) > 0
    mu, nu = _port_layout(kind, adam["mu"]), _port_layout(kind, adam["nu"])
    want_p = _port_layout(kind, store["params"])
    for pname, p in st.model.named_parameters():
        state = st.optimizer.state[p]
        assert int(state["step"]) == int(adam["count"]) > 0, pname
        np.testing.assert_array_equal(_bits(p), _bits(want_p[pname]), err_msg=pname)
        np.testing.assert_array_equal(_bits(state["exp_avg"]), _bits(mu[pname]), err_msg=pname)
        np.testing.assert_array_equal(_bits(state["exp_avg_sq"]), _bits(nu[pname]),
                                      err_msg=pname)
    pname, path, how = SPOT[kind]
    leaf = adam["nu"]["params"]
    for k in path:
        leaf = leaf[k]
    got = dict(st.model.named_parameters())[pname]
    got = st.optimizer.state[got]["exp_avg_sq"]
    if kind == "gru":          # the z gate is the second row block of the fused matrix
        H = got.shape[0] // 3
        got = got[H:2 * H]
    np.testing.assert_array_equal(_bits(got), np.ascontiguousarray(how(np.asarray(leaf)))
                                  .view(np.int32))


@pytest.mark.parametrize("asked,name", [("central", "policy_mlp_cfg1"),
                                        ("mlp", "policy_central_multi"),
                                        ("gru", "policy_mlp_cfg1"),
                                        ("mlp", "policy_sac_cfg1")])
def test_a_store_of_another_family_raises(asked, name):
    """mlp's leaves all fit the central model's actor and vf, so the store's
    own set of leaves decides; SAC stores hold no Adam state."""
    with pytest.raises(ValueError):
        load_train_state(name, asked)


def _jax_resumed(learner, store):
    """The JAX learner's TrainState restored from ``store`` as train.py does:
    the params and Adam's state replaced, update_count left at 0."""
    params = jax.tree.map(jnp.asarray, store["params"])
    opt = learner.tx.init(params)
    a = store["opt_state"][1][0]
    adam = opt[1][0]._replace(count=jnp.asarray(a["count"], jnp.int32),
                              mu=jax.tree.map(jnp.asarray, a["mu"]),
                              nu=jax.tree.map(jnp.asarray, a["nu"]))
    opt = (opt[0], (adam,) + tuple(opt[1][1:]))
    return JaxTrainState(params, opt, jnp.int32(0))


def _perms(n, epochs=2):
    perms, k = [], jax.random.PRNGKey(11)
    for _ in range(epochs):
        k, kp = jax.random.split(k)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, n))))
    return perms


def _hold(kind, ts, m, jts, jm, count, before):
    tol = UPDATE_TOL["float32"]
    for k_ in jm:
        np.testing.assert_allclose(m[k_].item(), float(jm[k_]), rtol=tol["metric"],
                                   atol=tol["metric"] * 0.1, err_msg=k_)
    adam = jts.opt_state[1][0]
    want_p, want_mu, want_nu = (_port_layout(kind, jax.tree.map(np.asarray, t))
                                for t in (jts.params, adam.mu, adam.nu))
    moved = 0.0
    for name, p in ts.model.named_parameters():
        st = ts.optimizer.state[p]
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), rtol=0,
                                   atol=tol["param"], err_msg=name)
        for got, want in ((st["exp_avg"], want_mu[name]), (st["exp_avg_sq"], want_nu[name])):
            w = want.numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=tol["moment"] * np.abs(w).max(), err_msg=name)
        assert int(st["step"]) == int(adam.count) == count + 4
        moved = max(moved, float(np.abs(want_p[name].numpy() - before[name]).max()))
    assert moved > 100 * tol["param"]        # the update moved the weights


def _config1_trajectory(fm, params, T, B, seed=3):
    """(obs, raw, old_logp, adv, ret, old_value) of T steps of B config-1 envs
    under random actions: the observations the port's env gives, the rest
    made from them as tests/test_torch_ppo.py's ``_batch`` makes it."""
    rng = np.random.RandomState(seed)
    env = port_env(1)
    venv = VectorEnv(env, num_envs=B, route_pool=env.table.route_ids([("IN_6", "OUT_2")]))
    state, o = venv.reset()
    obs = []
    for _ in range(T):
        obs.append(o.numpy())
        a = torch.from_numpy(rng.uniform(-1, 1, (B, 1, 2)).astype(np.float32))
        state, out = venv.step(state, a)
        o = out.obs
    obs = np.stack(obs)
    mean, log_std, value = (np.asarray(a) for a in fm.apply(params, obs))
    raw = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    old_logp = (np.asarray(jax_logp(mean, log_std, raw)[0])
                + rng.normal(0, 0.05, value.shape)).astype(np.float32)
    adv = rng.normal(0.3, 1.5, value.shape).astype(np.float32)
    ret = (value + rng.normal(0, 0.5, value.shape)).astype(np.float32)
    old_value = (value + rng.normal(0, 0.3, value.shape)).astype(np.float32)
    return obs, raw, old_logp, adv, ret, old_value


def test_resumed_mlp_update_replays_the_jax_learner():
    """One update (2 epochs x 2 minibatches over T=4) resumed from
    policy_mlp_cfg1 on a fixed config-1 trajectory, float32, against the JAX
    learner restored from the orbax store."""
    T, B, N = 4, 8, 1
    store = _store("policy_mlp_cfg1")
    fm = FlaxMLP(compute_dtype=jnp.float32)
    jcfg = JaxPPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2)
    jl = JaxPPOLearner(None, fm, jcfg)
    jts = _jax_resumed(jl, store)
    count = int(jts.opt_state[1][0].count)
    obs, raw, old_logp, adv, ret, old_value = _config1_trajectory(fm, jts.params, T, B)
    assert not obs[..., 21:31].any()       # the neighbour slots config 1 never sets
    z = np.zeros((T, B, N), np.float32)
    jtraj = JaxTransition(obs=obs, raw_action=raw, logp=old_logp, value=old_value, reward=z,
                          ep_done=np.zeros((T, B), bool), agent_done=z.astype(bool),
                          status=z.astype(np.int32))
    jts, jm = jax.jit(jl._update)(jts, jtraj, adv, ret, jax.random.PRNGKey(11))

    perms = _perms(T)
    st = load_train_state("policy_mlp_cfg1", "mlp", model=make_model("mlp", **F32))
    before = {k: v.detach().numpy().copy() for k, v in st.model.named_parameters()}
    venv = VectorEnv(port_env(N), num_envs=B, seed=0)
    learner = PPOLearner(venv, st.model, PPOConfig(rollout_len=T, update_epochs=2,
                                                   num_minibatches=2),
                         perm_fn=lambda n: perms.pop(0))
    ts = TrainState(st.model, st.optimizer, 0)
    traj = _port_traj(z, old_value, np.zeros((T, B), bool), z.astype(bool), obs=obs,
                      raw_action=raw, logp=old_logp)
    ts, m = learner.update(ts, traj, torch.from_numpy(adv), torch.from_numpy(ret))
    assert not perms and ts.update_count == int(jts.update_count) == 4
    _hold("mlp", ts, m, jts, jm, count, before)


def test_resumed_gru_update_replays_the_jax_learner():
    """One recurrent update (2 epochs x 2 chunks over T=8) resumed from
    policy_gru_cfg1, float32, against the JAX recurrent learner restored from
    the store."""
    T, B, N = 8, 4, 2
    store = _store("policy_gru_cfg1")
    fm = FlaxGRU(compute_dtype=jnp.float32)
    jcfg = JaxPPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2)
    jl = JaxRecurrentPPOLearner(None, fm, jcfg)
    jts = _jax_resumed(jl, store)
    count = int(jts.opt_state[1][0].count)
    H = int(np.shape(store["params"]["params"]["gru"]["hn"]["kernel"])[0])
    rng = np.random.RandomState(5)
    obs = rng.uniform(-1, 1, (T, B, N, 127)).astype(np.float32)
    h_in = rng.uniform(-0.5, 0.5, (T, B, N, H)).astype(np.float32)
    done = rng.uniform(size=(T, B, N)) < 0.2
    raw = rng.normal(0, 0.5, (T, B, N, 2)).astype(np.float32)
    old_logp = rng.normal(-2, 0.3, (T, B, N)).astype(np.float32)
    old_value = rng.normal(0, 0.5, (T, B, N)).astype(np.float32)
    adv = rng.normal(0.3, 1.5, (T, B, N)).astype(np.float32)
    ret = (old_value + rng.normal(0, 0.5, (T, B, N))).astype(np.float32)
    z = np.zeros((T, B, N), np.float32)
    jtraj = JaxRecTransition(obs=obs, h_in=h_in, raw_action=raw, logp=old_logp, value=old_value,
                             reward=z, ep_done=np.zeros((T, B), bool), agent_done=done,
                             done=done, status=z.astype(np.int32))
    jts, jm = jax.jit(jl._update)(jts, jtraj, adv, ret, jax.random.PRNGKey(11))

    perms = _perms(2)
    st = load_train_state("policy_gru_cfg1", "gru", model=make_model("gru", **F32))
    before = {k: v.detach().numpy().copy() for k, v in st.model.named_parameters()}
    venv = VectorEnv(port_env(N), num_envs=B, seed=1)
    learner = RecurrentPPOLearner(venv, st.model, PPOConfig(rollout_len=T, update_epochs=2,
                                                            num_minibatches=2),
                                  perm_fn=lambda n: perms.pop(0))
    ts = TrainState(st.model, st.optimizer, 0)
    t = lambda a: torch.from_numpy(np.array(a))
    ptraj = RecTransition(obs=t(obs), h_in=t(h_in), raw_action=t(raw), logp=t(old_logp),
                          value=t(old_value), reward=t(z), ep_done=t(np.zeros((T, B), bool)),
                          agent_done=t(done), done=t(done), status=t(z.astype(np.int32)))
    ts, m = learner.update(ts, ptraj, t(adv), t(ret))
    assert not perms and ts.update_count == int(jts.update_count) == 4
    _hold("gru", ts, m, jts, jm, count, before)


def test_train_resumes_a_shipped_store(tmp_path, capsys):
    """train --resume policy_mlp_cfg1: 2 updates from the store's update on,
    the minibatch counter from 0, the weights and Adam state the store's at
    the start; the wrong family raises."""
    logs = _run(capsys, "--updates", 2, "--resume", "policy_mlp_cfg1",
                "--checkpoint", tmp_path / "a")
    assert sorted(logs) == [750, 751]
    assert all(np.isfinite(ln[k]) for ln in logs.values() for k in ("pg_loss", "v_loss"))
    saved = restore_checkpoint(tmp_path / "a")
    assert saved["update"] == 752 and saved["update_count"] == 32
    assert all(int(s["step"]) == 750 * 16 + 32 for s in saved["optimizer"]["state"].values())
    with pytest.raises(ValueError, match="central"):
        _run(capsys, "--updates", 1, "--model", "central", "--resume", "policy_mlp_cfg1")


@pytest.mark.parametrize("source", ["snapshot", "shipped"])
def test_resumed_run_masks_the_actor_while_the_warmup_is_due(tmp_path, capsys, monkeypatch,
                                                             source):
    """--critic-warmup 1 after a resume masks the actor loss on the whole
    first resumed update (16 minibatches) and not on the second, as train.py
    does; restoring the snapshot's counter (32) would have unmasked it."""
    if source == "snapshot":
        _run(capsys, "--updates", 2, "--checkpoint", tmp_path / "a")
        assert restore_checkpoint(tmp_path / "a")["update_count"] == 32
        resume = tmp_path / "a"
    else:
        resume = "policy_mlp_cfg1"
    actor_on = []
    loss = ppo_mod.PPOLearner._loss

    def spy(self, model, batch, on=1.0):
        actor_on.append(on)
        return loss(self, model, batch, on)

    monkeypatch.setattr(ppo_mod.PPOLearner, "_loss", spy)
    logs = _run(capsys, "--updates", 2, "--resume", resume, "--critic-warmup", 1)
    assert len(logs) == 2 and actor_on == [0.0] * 16 + [1.0] * 16


def test_warm_start_central_keeps_the_mlp_actor(tmp_path, capsys):
    """The transplanted central model's means and log_std equal the mlp
    policy's bit for bit (tests/test_central.py's contract); train --model
    central resumes the snapshot with a critic warm-up; a source without the
    mlp actor raises."""
    out = tmp_path / "w"
    warm_start_central.main(["--source", "policy_mlp_cfg1", "--out", str(out), "--agents", "4"])
    snap = restore_checkpoint(out)
    assert snap["update"] == 0 and not snap["optimizer"]["state"]
    mlp, _ = load_policy("policy_mlp_cfg1", "mlp", device="cpu")
    central, _ = load_policy(out, "central", device="cpu")
    obs = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (5, 3, 127))
                           .astype(np.float32))
    with torch.no_grad():
        m_ref, ls_ref, _ = mlp(obs)
        m_new, ls_new, _ = central(obs)
    assert torch.equal(m_ref, m_new) and torch.equal(ls_ref, ls_new)
    assert torch.equal(central.critic_embed.weight, make_model("central").critic_embed.weight)
    logs = _run(capsys, "--updates", 2, "--model", "central", "--resume", out,
                "--critic-warmup", 1)
    assert sorted(logs) == [0, 1]
    assert logs[0]["pg_loss"] == 0.0 and logs[0]["approx_kl"] == 0.0   # the actor held still
    assert logs[1]["approx_kl"] != 0.0
    for bad in ("policy_conv_cfg1", "policy_sac_cfg1"):
        with pytest.raises(ValueError, match="lacks"):
            warm_start_central.warm_start(bad, tmp_path / bad)
