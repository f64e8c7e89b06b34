"""Property fuzz of the port: tests/test_fuzz.py and tests/test_npc_fuzz.py
for marl_traffic_intersection_tpu_torch, on the CPU.

  * Random action streams (uniform, from a seeded torch generator) through
    the batched env, with and without traffic, and four saturated
    patterns: the same state and observation invariants as the JAX
    package's test_fuzz.py (finite values, statuses in their domain, speed,
    heading, path index and lidar in range, the observation's blocks
    bounded).
  * Adversarial NPC fleets (test_npc_fuzz.py's generator: up to all 32
    slots alive, dense clusters, shuffled uids, coincident poses), 25 a
    cluster size batched as 25 envs of one call: the exact controller's
    ``slot`` and ``wave`` schedules bit-equal to the serial transcription,
    the collision pass bit-equal to its serial form, and the controller
    bit-equal to the JAX package's exact chain on the same fleets.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core import npc as jnpc
from marl_traffic_intersection_tpu_torch.core import npc
from marl_traffic_intersection_tpu_torch.core.constants import (LIDAR_MAX_DIST, PATH_LEN,
                                                                PHYSICS_MAX_SPEED)
from marl_traffic_intersection_tpu_torch.core.env import EnvConfig, IntersectionEnv
from marl_traffic_intersection_tpu_torch.core.routes import build_route_table
from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv

from ._torch_port import assert_npc_bits, ieee_constant_division
from .test_npc_fuzz import _random_fleet, _table

FLEETS = 25
DT = np.float32(1.0 / 60.0)


def _rollout(cfg: EnvConfig, num_envs: int, steps: int, seed: int):
    venv = VectorEnv(IntersectionEnv(cfg, device="cpu"), num_envs, seed=seed)
    state, obs = venv.reset()
    gen = torch.Generator().manual_seed(seed + 1)
    statuses, rewards = [], []
    for _ in range(steps):
        act = torch.rand((num_envs, cfg.num_agents, 2), generator=gen) * 2.0 - 1.0
        state, out = venv.step(state, act)
        statuses.append(out.status)
        rewards.append(out.reward)
    return state, out.obs, torch.stack(statuses), torch.stack(rewards)


@pytest.mark.parametrize("agents,traffic", [(1, False), (4, False), (8, True)])
def test_rollout_invariants(agents, traffic):
    cfg = EnvConfig(num_agents=agents, traffic_flow=traffic,
                    traffic_density=1.0 if traffic else 0.5, max_steps=64, npc_mode="fast")
    state, obs, statuses, rewards = _rollout(cfg, num_envs=32, steps=96, seed=agents)

    assert torch.isfinite(obs).all(), "non-finite observation"
    assert torch.isfinite(rewards).all(), "non-finite reward"
    assert statuses.min() >= 0 and statuses.max() <= 5, "status out of domain"

    ego = state.ego
    assert (ego.v >= 0).all() and (ego.v <= PHYSICS_MAX_SPEED + 1e-5).all()
    assert torch.isfinite(ego.heading).all() and (ego.heading.abs() <= np.pi + 1e-5).all()
    assert (ego.path_index >= 0).all() and (ego.path_index < PATH_LEN).all()
    assert (state.lidar >= 0).all() and (state.lidar <= LIDAR_MAX_DIST + 1e-5).all()

    # the observation's lidar block normalised to [0, 1]; its base block bounded
    assert (obs[..., 31:] >= 0).all() and (obs[..., 31:] <= 1 + 1e-6).all()
    assert obs[..., :4].abs().max() <= 2.0

    if traffic:
        assert state.npc.alive.shape[-1] == cfg.max_npcs
        # dead slots hold no NaN that a mask could leak
        assert torch.isfinite(state.npc.x).all() and torch.isfinite(state.npc.v).all()
        assert int(state.npc.alive.sum()) > 0


def test_extreme_actions_stay_finite():
    """Saturated and degenerate in-domain actions: full throttle and steer
    either way, exact zeros (the float-equality decay branch), and
    alternating bang-bang."""
    venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4, max_steps=64), device="cpu"), 16,
                     seed=0)
    state, _ = venv.reset()
    patterns = [torch.ones((16, 4, 2)), -torch.ones((16, 4, 2)), torch.zeros((16, 4, 2)),
                torch.tensor([[1.0, -1.0]]).repeat(16, 4, 1)]
    for t in range(60):
        state, out = venv.step(state, patterns[t % len(patterns)])
    assert torch.isfinite(out.obs).all()
    assert torch.isfinite(out.reward).all()
    assert torch.isfinite(state.ego.x).all()


# ------------------------------------------------------- adversarial fleets
def _fleets(cluster: float):
    """test_npc_fuzz.py's 25 fleets of this cluster size, stacked on an env
    axis as numpy arrays (next_uid (FLEETS,))."""
    rng = np.random.RandomState(int(cluster))
    fleets = [_random_fleet(rng, cluster) for _ in range(FLEETS)]
    return {f: np.stack([np.asarray(getattr(s, f)) for s in fleets])
            for f in jnpc.NpcState._fields}


@pytest.fixture(scope="module")
def paths():
    table = build_route_table(3).paths
    assert np.array_equal(table, np.asarray(_table()))
    return table


@pytest.mark.parametrize("cluster", [60.0, 150.0, 400.0])
def test_exact_controller_on_adversarial_fleets(paths, cluster):
    st = _fleets(cluster)
    fleet = lambda: npc.NpcState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    tpaths, dt = torch.from_numpy(paths), torch.tensor(DT)
    stats = {"slot": collections.Counter(), "wave": collections.Counter()}
    slot = npc.npc_controller_update(fleet(), tpaths, dt, stats=stats["slot"])
    wave = npc.npc_controller_update(fleet(), tpaths, dt, wave_cleanup=True, stats=stats["wave"])
    serial = npc.npc_controller_update_serial(fleet(), tpaths, dt)
    for name, got in (("slot", slot), ("wave", wave)):
        assert_npc_bits(serial, got, f"{name} against serial, cluster {cluster}")
    assert_npc_bits(npc.npc_collisions_serial(serial), npc.npc_collisions(slot),
                    f"collisions, cluster {cluster}")

    jpaths, jdt = jnp.asarray(paths), jnp.float32(DT)
    with ieee_constant_division():
        exact = jax.jit(jax.vmap(lambda s: jnpc.npc_controller_update(
            s, jpaths, jdt, exact_acc=True))).lower(jnpc.NpcState(**st)).compile()
    want = exact(jnpc.NpcState(**{k: jnp.asarray(v) for k, v in st.items()}))
    assert_npc_bits(want, slot, f"the JAX exact chain, cluster {cluster}")
    # the fleets move, and the dependent slots were replayed
    moved = (slot.x.numpy() != st["x"]) & st["alive"]
    assert moved.sum() >= st["alive"].sum() // 2
    print(f"cluster {cluster}: alive {int(st['alive'].sum())} of {st['alive'].size}, "
          f"{dict(stats['slot'])}, wave {dict(stats['wave'])}")
    assert stats["slot"]["cleanup_rounds"] > 0 and stats["wave"]["cleanup_rounds"] > 0
