"""The traffic step graphed by segments between the host's decisions
(envs/vector.py, utils/graphs.py::Segments), on the CPU, every graph
replaced by a re-run of its function (tests/test_torch_graphs.py's
``rerun_graphs``), so the segments' keys, static buffers and host loops
run as on the card:

  - ``_GraphedStep`` with traffic bit-equal to the eager ``step`` at 8 x 2
    with 8 NPC slots (widths 2, 4 and the full 8) for the exact mode's
    ``slot`` and ``wave`` cleanups, ``fast`` and ``serial``, over 60 steps
    with resets and both ``final_obs``, and ``npc_stats``' counts equal
    (the graphed run also sums the device's idle after its reads). A fleet
    injected at the start (packed NPCs, two pairs at one pose) and spawns
    tried every other step make the run switch widths and back, replay
    dependent slots and run the collision cascade: the test asserts all
    three, so it cannot pass on a run that never reached a loop;
  - the segmented step bit-equal to the JAX package's
    ``VectorEnv.jit_step`` with traffic, the JAX side's routes and spawn
    draws injected, on the exact chain;
  - the graphed train step with traffic bit-equal to ``train_step``, with
    and without the reward normaliser;
  - ``Segments``: a carried result in buffers made once, in-place rounds,
    and a call on other input buffers refused.

The card's side (real captures and replays, a width switch back to a
segment captured before it) is in tests/test_torch_cuda.py and
chip_smoke.py's traffic phase.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core.constants import DT_DEFAULT
from marl_traffic_intersection_tpu.core.npc import spawn_decision
from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu_torch import VectorEnv
from marl_traffic_intersection_tpu_torch.core.npc import NpcState
from marl_traffic_intersection_tpu_torch.envs import vector as vector_module
from marl_traffic_intersection_tpu_torch.envs.normalize import RewardNormVecEnv
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.parallel import ppo
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner
from marl_traffic_intersection_tpu_torch.utils import graphs
from marl_traffic_intersection_tpu_torch.utils.graphs import stat_counts

from ._torch_port import (_jax_reset_state, assert_npc_bits, compare_runs,
                          ieee_constant_division, jax_env, port_env)
from .test_torch_graphs import (_Pool, _assert_train_runs, _assert_trees, _train_pair,
                                rerun_graphs)  # noqa: F401 (a fixture)

B, N, SLOTS, STEPS, MAX_STEPS = 8, 2, 8, 60, 20
MODES = {"exact slot": dict(npc_mode="exact", npc_cleanup="slot"),
         "exact wave": dict(npc_mode="exact", npc_cleanup="wave"),
         "fast": dict(npc_mode="fast"), "serial": dict(npc_mode="serial")}


def _fleet(env, rng) -> NpcState:
    """A pool with NPCs packed about the centre: slots 0-4 of env 0 (the
    full width), two of them at one pose, and two at one pose in env 1."""
    shape = (B, SLOTS)
    alive = np.zeros(shape, bool)
    alive[0, :5] = alive[1, :2] = True
    x = rng.uniform(335, 415, shape).astype(np.float32)
    y = rng.uniform(335, 415, shape).astype(np.float32)
    x[0, 1], y[0, 1] = x[0, 0], y[0, 0]
    x[1, 1], y[1, 1] = x[1, 0], y[1, 0]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))
    return NpcState(alive=torch.from_numpy(alive), x=f32(x), y=f32(y),
                    v=f32(rng.uniform(0, 8, shape)), heading=f32(rng.uniform(-np.pi, np.pi, shape)),
                    steering_angle=f32(np.zeros(shape)),
                    route_id=i32(rng.choice(env.traffic_ids.numpy(), shape)),
                    path_index=i32(rng.randint(0, 160, shape)),
                    uid=i32(np.tile(np.arange(SLOTS), (B, 1))), next_uid=i32(np.full(B, SLOTS)))


def _spawns(seed, num_routes):
    rng = np.random.RandomState(seed)

    def sampler(k):
        return (torch.from_numpy(rng.uniform(size=k) < 0.5),
                torch.from_numpy(rng.randint(num_routes, size=k).astype(np.int32)))
    return sampler


def _forward(rng):
    """Mostly forward, so that the egos leave the spawn points to the NPCs."""
    return torch.from_numpy(np.stack([rng.uniform(0.2, 1.0, (B, N)),
                                      rng.uniform(-0.2, 0.2, (B, N))], -1).astype(np.float32))


def _widths(stats, before) -> list:
    return [k for k in stats if k.startswith("step_width_") and stats[k] > before[k]]


def _switches_back(seq) -> bool:
    """Whether a width recurs after another one ran in between."""
    runs = [w for i, w in enumerate(seq) if i == 0 or seq[i - 1] != w]
    return len(runs) > len(set(runs))


@pytest.mark.parametrize("mode", list(MODES))
def test_segmented_traffic_step_equals_the_eager_step(rerun_graphs, mode):
    def make():
        env = port_env(N, traffic_flow=True, max_npcs=SLOTS, max_steps=MAX_STEPS, **MODES[mode])
        return VectorEnv(env, num_envs=B, seed=6,
                         spawn_sampler=_spawns(7, env.traffic_ids.shape[0]))

    ev, gv = make(), make()
    fleet = _fleet(ev.env, np.random.RandomState(5))
    se, _ = ev.reset()
    sg, _ = gv.reset()
    se, sg = se._replace(npc=fleet), sg._replace(npc=graphs.clone_tree(fleet))
    step = vector_module._GraphedStep(gv, DT_DEFAULT, donate=True)
    rng, widths, resets = np.random.RandomState(8), [], 0
    for t in range(STEPS):
        a, final = _forward(rng), t % 3 == 0
        before = collections.Counter(ev.env.npc_stats)
        want = ev.step(se, a, final_obs=final)
        got = step(sg, a, final_obs=final)
        _assert_trees(f"{mode} step {t}", want, got)
        widths += _widths(ev.env.npc_stats, before)
        resets += int((want[1].terminated | want[1].truncated).sum())
        se, sg = want[0], got[0]
        assert sg is step.state
    stats = ev.env.npc_stats
    assert stat_counts(stats) == stat_counts(gv.env.npc_stats), (stats, gv.env.npc_stats)
    assert len(widths) == STEPS and len(set(widths)) >= 2 and _switches_back(widths), widths
    assert resets >= B
    begun = {k[0] for k in step.graphs if k[1:] == ("npc begin",)}
    if mode.startswith("exact"):
        top = max(int(k[len("npc_rounds_at_"):]) for k in stats if k.startswith("npc_rounds_at_"))
        assert top >= 1 and stats["cleanup_rounds"] >= 1 and stats["collision_rounds"] >= 1, stats
        assert len(begun) >= 2, sorted(step.graphs, key=str)
    else:
        assert not begun          # fast and serial: one segment per width
    assert len({k[1] for k in step.graphs if k[0] == "step"}) >= 2


def test_segmented_traffic_step_equals_the_jax_jit_step(rerun_graphs):
    """The segmented step against the JAX package's ``VectorEnv.jit_step``
    with one narrowed width (``npc_tier=2`` of 8 slots, so that JAX compiles
    two branches of its width ladder; density 8, 8 x 2, 30 steps; the JAX
    reset routes and per-env spawn draws replayed into the port): every
    NpcState field every step, then every leaf, output and observation on
    the reference chain. The JAX side marches its dense lidar
    (``lidar_impl="xla"``, bit-equal to its default), which traces faster."""
    density, steps = 8.0, 30
    kw = dict(traffic_flow=True, traffic_density=density, max_npcs=SLOTS, npc_tier=2,
              max_steps=10 ** 6, lidar_impl="xla")
    jenv = jax_env(N, **kw)
    jvenv = JaxVectorEnv(jenv, num_envs=B)
    jvenv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    js = _jax_reset_state(jvenv, 1)
    with ieee_constant_division():
        jstep = jvenv.jit_step(donate=False).lower(js, jnp.zeros((B, N, 2), jnp.float32)).compile()
    T = int(jenv.table.traffic_route_ids.shape[0])
    draw = jax.jit(jax.vmap(lambda k: spawn_decision(
        jax.random.split(k)[1], T, density, jnp.float32(DT_DEFAULT))))

    replay = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    pvenv = VectorEnv(port_env(N, **kw), num_envs=B,
                      route_sampler=lambda k: replay["rid"][:k],
                      spawn_sampler=lambda k: (replay["try"][:k], replay["route"][:k]))
    ps, pobs0 = pvenv.reset()
    pstep = vector_module._GraphedStep(pvenv, DT_DEFAULT, donate=True)
    rng = np.random.RandomState(2)
    jax_steps, port_steps = [], []
    for t in range(steps):
        a = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
        do_try, route = draw(js.key)
        replay["try"] = torch.from_numpy(np.array(do_try))
        replay["route"] = torch.from_numpy(np.array(route))
        js, jout = jstep(js, jnp.asarray(a))
        replay["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pstep(ps, torch.from_numpy(a))
        assert_npc_bits(js.npc, ps.npc, f"step {t}")
        jax_steps.append((js, jout))
        port_steps.append(graphs.clone_tree((ps, pout)))
    stats = pvenv.env.npc_stats
    assert stats["tier_reads"] == steps and stats["step_width_2"] and stats["step_width_8"], stats
    assert any(k[1:] == ("npc begin",) for k in pstep.graphs)
    compare_runs(jax_steps, port_steps, True, jenv, reset=(_jax_reset_state(jvenv, 1), pobs0))


@pytest.mark.parametrize("norm", [False, True])
def test_graphed_train_step_with_traffic_equals_train_step(rerun_graphs, norm):
    """2 updates at 16 x 2, rollout 8, exact NPC mode (``jit_train_step``'s
    step on the card, here with every graph re-run), bit-equal to
    ``train_step`` with the same host reads and loop rounds; with and
    without the reward normaliser. On the CPU ``jit_train_step`` itself is
    ``train_step``."""
    learners = []

    def make():
        venv = VectorEnv(port_env(N, traffic_flow=True, traffic_density=6.0, max_npcs=SLOTS,
                                  max_steps=12), num_envs=16, seed=3)
        lrn = PPOLearner(RewardNormVecEnv(venv) if norm else venv, make_model("mlp", seed=3),
                         PPOConfig(rollout_len=8), seed=3)
        learners.append(lrn)
        return lrn

    steps = []

    def graphed_step(lrn):
        steps.append(ppo.TrainStep(lrn, graphed=True))
        return steps[-1]
    eager, graphed = _train_pair(make, 2, graphed_step)
    _assert_train_runs(eager, graphed)
    e, g = (stat_counts(lrn.env.env.npc_stats) for lrn in learners)
    assert e == g and e["tier_reads"] == 16, (e, g)
    keys = steps[0].run.graphs
    assert ("act",) in keys and any(k[1:] == ("npc begin",) for k in keys), sorted(keys, key=str)
    lrn = make()
    assert lrn.jit_train_step() == lrn.train_step


def test_segments_carry_static_buffers_and_refuse_other_inputs(rerun_graphs):
    """``carry`` copies each result into the buffers its first call made;
    a round updates them in place; a key called on other input buffers
    raises, a view of the same buffer passes."""
    segs = graphs.Segments(_Pool("cpu"))
    x = torch.arange(4.0)

    def double(t):
        return t * 2, t + 1
    first = segs.carry(("double",), double, x)
    x.add_(1)
    again = segs.carry(("double",), double, x[:])
    assert again is first and first[0].tolist() == [2.0, 4.0, 6.0, 8.0]
    segs(("round",), lambda c: c[1].mul_(2), first)
    segs(("round",), lambda c: c[1].mul_(2), first)
    assert first[1].tolist() == [8.0, 12.0, 16.0, 20.0]
    assert sorted(segs.graphs) == [("double",), ("round",)] and len(rerun_graphs) == 2
    with pytest.raises(ValueError, match="other input buffers"):
        segs.carry(("double",), double, x.clone())
    with pytest.raises(ValueError, match="other input buffers"):
        segs(("round",), lambda c: c[1].mul_(2), graphs.clone_tree(first))
