"""The port's counterpart of ``jax.jit`` on the main path (utils/graphs.py),
on the CPU, where it runs eagerly:

  - ``VectorEnv.step``, now ``draws`` then ``step_body``, bit-equal to the
    step before that split (kept here as ``_step_before_the_split``) over 60
    steps at 8 x 2 with auto-resets: the default route sampler, an injected
    one, and ``final_obs``;
  - ``VectorEnv.jit_step(donate)`` bit-equal to the JAX package's
    ``VectorEnv.jit_step(donate)``, the JAX side's routes injected (the
    exact chain, so every leaf, reward and observation bit for bit);
  - ``PPOLearner.jit_train_step()`` bit-equal to ``train_step``, and the
    configurations that cannot be graphed raising;
  - the graphed steps' static buffers with each graph replaced by a re-run
    of its function (``_Rerun``, the segments' graphs included): the
    donation contract and the trajectory, GAE and update buffers, bit-equal
    to the eager steps;
  - the loaders' card default, and Adam's switch to and from capturable.

The card's side (a real capture and replay) is in tests/test_torch_cuda.py
and chip_smoke.py's ``graphs`` phase; the traffic step's segments in
tests/test_torch_graphs_traffic.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu_torch import EnvState, VectorEnv
from marl_traffic_intersection_tpu_torch.envs import vector as vector_module
from marl_traffic_intersection_tpu_torch.envs.normalize import RewardNormVecEnv
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.parallel import ppo
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner
from marl_traffic_intersection_tpu_torch.parallel.recurrent_ppo import RecurrentPPOLearner
from marl_traffic_intersection_tpu_torch.utils import graphs
from marl_traffic_intersection_tpu_torch.utils.checkpoint import load_policy, load_sac
from marl_traffic_intersection_tpu_torch.utils.graphs import stat_counts

from ._torch_port import (EXACT_COMPILE, _jax_reset_state, assert_bits, compare_runs, jax_env,
                          port_env)

B, N = 8, 2


def _step_before_the_split(venv, state, actions, dt=1.0 / 60.0, final_obs=False):
    """VectorEnv.step as it was before ``draws``/``step_body`` (no traffic):
    the route draw after the env's step."""
    new_state, out = venv.env.step(state, actions, dt, with_obs=False)
    ep_done = out.terminated | out.truncated
    fresh = venv.env.reset_state(venv.route_sampler(venv.num_envs)[venv.rows])

    def pick(a, b):
        return torch.where(ep_done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    merged = EnvState(
        ego=type(new_state.ego)(*(pick(a, b) for a, b in zip(fresh.ego, new_state.ego))),
        lidar=pick(fresh.lidar, new_state.lidar),
        step_count=pick(fresh.step_count, new_state.step_count), npc=new_state.npc)
    out = out._replace(obs=venv.env.observe(merged))
    if final_obs:
        return merged, out, venv.env.observe(new_state)
    return merged, out


def _actions(rng):
    return torch.from_numpy(np.stack([rng.uniform(-0.3, 1.0, (B, N)),
                                      rng.uniform(-1, 1, (B, N))], -1).astype(np.float32))


def _injected(seed):
    rng = np.random.RandomState(seed)

    def sampler(k):
        return torch.from_numpy(np.stack([rng.permutation(12)[:N] for _ in range(k)])
                                .astype(np.int32))
    return sampler


def _assert_trees(name, want, got):
    for i, (a, b) in enumerate(zip(graphs.leaves(want), graphs.leaves(got))):
        assert_bits(f"{name} leaf {i}", a, b)


@pytest.mark.parametrize("case", ["default sampler", "injected sampler", "final_obs"])
def test_split_step_equals_the_step_before_the_split(case):
    def make():
        sampler = _injected(3) if case == "injected sampler" else None
        return VectorEnv(port_env(N, max_steps=10), num_envs=B, seed=5, route_sampler=sampler)

    old, new = make(), make()
    so, _ = old.reset()
    sn, _ = new.reset()
    final = case == "final_obs"
    rng, resets = np.random.RandomState(0), 0
    for t in range(60):
        a = _actions(rng)
        want = _step_before_the_split(old, so, a, final_obs=final)
        got = new.step(sn, a, final_obs=final)
        (so, *rest_o), (sn, *rest_n) = want, got
        _assert_trees(f"step {t}", want, got)
        resets += int((rest_o[0].terminated | rest_o[0].truncated).sum())
    assert resets >= 2 * B
    assert torch.equal(old.generator.get_state(), new.generator.get_state())


def _jax_vector(max_steps):
    jenv = jax_env(N, max_steps=max_steps)
    venv = JaxVectorEnv(jenv, num_envs=B)
    # the exact observation takes minutes to compile inside the step: the
    # JAX side steps without it and compare_runs rebuilds it from the states
    venv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    return jenv, venv


@pytest.mark.parametrize("donate", [True, False])
def test_jit_step_on_the_cpu_equals_the_jax_jit_step(donate):
    """Bit-equal under the exact chain, 40 steps with episodes of 10."""
    jenv, jvenv = _jax_vector(max_steps=10)
    js = _jax_reset_state(jvenv, 0)
    jstep = jvenv.jit_step(donate=donate).lower(js, jnp.zeros((B, N, 2), jnp.float32)).compile(
        compiler_options=EXACT_COMPILE)

    next_ids = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    pvenv = VectorEnv(port_env(N, max_steps=10), num_envs=B,
                      route_sampler=lambda k: next_ids["rid"][:k])
    ps, pobs0 = pvenv.reset()
    pstep = pvenv.jit_step(donate=donate)
    rng, jax_steps, port_steps, resets = np.random.RandomState(5), [], [], 0
    for _ in range(40):
        a = _actions(rng)
        js, jout = jstep(js, jnp.asarray(a.numpy()))
        next_ids["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pstep(ps, a)
        resets += int(np.asarray(jout.terminated | jout.truncated).sum())
        # a donated state is deleted by the next call: keep host copies
        jax_steps.append(jax.tree.map(np.array, (js, jout)))
        port_steps.append((graphs.clone_tree(ps), graphs.clone_tree(pout)))
    assert resets >= 3 * B
    compare_runs(jax_steps, port_steps, True, jenv, reset=(_jax_reset_state(jvenv, 0), pobs0))


def test_jit_step_with_traffic_raises_naming_the_host_reads():
    """The traffic step is graphed now (by segments between the host's
    reads, tests/test_torch_graphs_traffic.py), so ``jit_step`` with traffic
    no longer raises: on the CPU it is ``step``, bit-equal over 20 steps,
    with the same host reads counted by name in ``npc_stats``."""
    def make():
        return VectorEnv(port_env(N, traffic_flow=True, traffic_density=6.0, max_npcs=8),
                         num_envs=B, seed=4)

    ev, jv = make(), make()
    es, _ = ev.reset()
    js, _ = jv.reset()
    jstep = jv.jit_step()
    rng = np.random.RandomState(2)
    for t in range(20):
        a = _actions(rng)
        want = ev.step(es, a, final_obs=t % 2 == 0)
        got = jstep(js, a, final_obs=t % 2 == 0)
        _assert_trees(f"step {t}", want, got)
        es, js = want[0], got[0]
    assert stat_counts(ev.env.npc_stats) == stat_counts(jv.env.npc_stats)
    assert jv.env.npc_stats["host_reads"] >= 20 and jv.env.npc_stats["tier_reads"] == 20


def _learner(seed=0, norm=False, **cfg):
    venv = VectorEnv(port_env(N, max_steps=12), num_envs=16, seed=seed)
    return PPOLearner(RewardNormVecEnv(venv) if norm else venv,
                      make_model("mlp", seed=seed), PPOConfig(rollout_len=8, **cfg), seed=seed)


def _train_pair(make, steps, graphed_step):
    """``steps`` updates of ``train_step`` and of ``graphed_step(learner)``
    from the same seeds: (eager, graphed), each ``(ts, env_state, obs,
    [metrics...])``."""
    runs = []
    for fn in (lambda lrn: lrn.train_step, graphed_step):
        lrn = make()
        ts = lrn.init()
        state, obs = lrn.env.reset()
        step, logs = fn(lrn), []
        for _ in range(steps):
            ts, state, obs, m = step(ts, state, obs, {})
            logs.append({k: v.clone() for k, v in m.items()})
        runs.append((ts, graphs.clone_tree(state), obs.clone(), logs))
    return runs


def _assert_train_runs(eager, graphed):
    (ts_e, st_e, ob_e, m_e), (ts_g, st_g, ob_g, m_g) = eager, graphed
    assert ts_e.update_count == ts_g.update_count
    _assert_trees("env state", st_e, st_g)
    assert_bits("obs", ob_e, ob_g)
    for u, (a, b) in enumerate(zip(m_e, m_g)):
        assert list(a) == list(b)
        for k in a:
            assert_bits(f"{k} of update {u}", a[k], b[k])
    for (name, p), q in zip(ts_e.model.named_parameters(), ts_g.model.parameters()):
        assert_bits(name, p, q)
        for k, v in ts_e.optimizer.state[p].items():
            assert_bits(f"{name} {k}", v, ts_g.optimizer.state[q][k])


def test_jit_train_step_on_the_cpu_equals_train_step():
    """2 updates at 16 x 2, rollout 8, bit for bit: on the CPU the step is
    ``train_step`` itself, as jax.jit compiles the same program there."""
    eager, graphed = _train_pair(_learner, 2, lambda lrn: lrn.jit_train_step())
    _assert_train_runs(eager, graphed)


def test_jit_train_step_raises_on_a_mesh_traffic_and_the_recurrent_learner():
    """A mesh and the GRU learner raise; traffic no longer does (its graphed
    step is tests/test_torch_graphs_traffic.py's)."""
    with pytest.raises(ValueError, match="distributed"):
        _learner().jit_train_step(mesh=object())
    with pytest.raises(NotImplementedError, match="eagerly"):
        RecurrentPPOLearner(VectorEnv(port_env(N), num_envs=4),
                            make_model("gru")).jit_train_step()


class _Pool:
    def __init__(self, device):
        self.device = device


class _Rerun:
    """A graph that re-runs its function at every call: the graphed steps'
    static buffers, on the CPU. ``made`` lists every one made."""

    made: list = []

    def __init__(self, fn, pool):
        self.fn, self.calls = fn, 0
        _Rerun.made.append(self)

    def __call__(self):
        self.calls += 1
        return self.fn()


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Every graph, the env step's and the learner's (each made by a
    ``Segments`` through ``graphs.Graph``), replaced by a ``_Rerun``;
    yields the list of those made."""
    monkeypatch.setattr(_Rerun, "made", [])
    monkeypatch.setattr(graphs, "Graph", _Rerun)
    monkeypatch.setattr(graphs, "GraphPool", _Pool)
    # capturable Adam runs on the card only; on the CPU the eager Adam
    monkeypatch.setattr(ppo, "capturable_", lambda opt, on=True: opt)
    yield _Rerun.made


@pytest.mark.parametrize("donate", [True, False])
def test_graphed_step_buffers_equal_the_eager_step(rerun_graphs, donate):
    """The graphed step's static buffers: bit-equal to ``step`` over 40
    steps with resets and both ``final_obs``; with donation the returned
    state is the static one, taken back without a copy, and ``out`` is
    overwritten by the next call; without, every call returns new tensors."""
    def make():
        return VectorEnv(port_env(N, max_steps=10), num_envs=B, seed=7)

    ev, gv = make(), make()
    se, _ = ev.reset()
    sg, _ = gv.reset()
    step = vector_module._GraphedStep(gv, 1.0 / 60.0, donate)
    rng = np.random.RandomState(1)
    for t in range(40):
        final = t % 3 == 0
        a = _actions(rng)
        want = ev.step(se, a, final_obs=final)
        got = step(sg, a, final_obs=final)
        _assert_trees(f"step {t}", want, got)
        if t and donate:
            assert got[0] is step.state and got[0] is sg
        elif t:
            assert all(x.data_ptr() != y.data_ptr()
                       for x, y in zip(graphs.leaves(got[0]), graphs.leaves(step.state))
                       if x.numel())
        se, sg = want[0], got[0]
    # without traffic the whole step is one segment, one graph per final_obs
    assert sorted(step.graphs) == [("step", None, False), ("step", None, True)]
    assert sum(g.calls for g in step.graphs.values()) == 40
    assert all(isinstance(g, _Rerun) for g in step.graphs.values())


@pytest.mark.parametrize("norm", [False, True])
def test_graphed_train_step_buffers_equal_train_step(rerun_graphs, norm):
    """The graphed train step's buffers (trajectory, step counter, GAE, the
    minibatch indices, the metric sums), with a critic warm-up so both
    update graphs run: bit-equal to ``train_step`` over 3 updates, with and
    without the reward normaliser."""
    def make():
        return _learner(seed=2, norm=norm, critic_warmup=1, update_epochs=2,
                        num_minibatches=2)

    eager, graphed = _train_pair(make, 3, lambda lrn: ppo.TrainStep(lrn, graphed=True))
    _assert_train_runs(eager, graphed)


def test_loaders_default_to_the_card(monkeypatch):
    """load_policy and load_sac run on the card unless asked for the CPU,
    as every entry point of the port: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_policy("policy_mlp_cfg1", "mlp"),
                 lambda: load_sac("policy_sac_cfg1")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model, _ = load_policy("policy_mlp_cfg1", "mlp", device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_capturable_switch_resumes_a_graphed_snapshot_on_the_cpu():
    """A snapshot saved by a graphed run holds capturable Adam groups;
    ``capturable_(opt, False)``, as train does for an eager stage, takes the
    step count back to the host, and the resumed Adam equals one that never
    left it."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(4))
    opt = torch.optim.Adam([w], lr=1e-2, eps=1e-8)
    for _ in range(3):
        opt.zero_grad()
        (w * w).sum().backward()
        opt.step()
    sd = copy.deepcopy(opt.state_dict())      # as saved: no tensor shared with opt
    sd["param_groups"][0]["capturable"] = True          # as a graphed run saves it
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = graphs.capturable_(torch.optim.Adam([w2], lr=1e-2, eps=1e-8), False)
    opt2.load_state_dict(sd)
    assert opt2.param_groups[0]["capturable"]
    graphs.capturable_(opt2, False)
    assert not opt2.param_groups[0]["capturable"]
    assert opt2.state[w2]["step"].device.type == "cpu"
    for p, o in ((w, opt), (w2, opt2)):
        o.zero_grad()
        (p * p).sum().backward()
        o.step()
    assert_bits("w", w.detach(), w2.detach())


def test_train_logs_which_step_runs(capsys):
    """Every log line names the step: on the CPU, train_step, eagerly."""
    import json

    from marl_traffic_intersection_tpu_torch import train

    train.main(["--device", "cpu", "--num-envs", "4", "--agents", "2", "--rollout-len", "8",
                "--updates", "2", "--log-every", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["step"] for ln in lines if "update" in ln] == ["eager", "eager"]
