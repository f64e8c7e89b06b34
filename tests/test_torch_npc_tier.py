"""NPC slot-prefix narrowing in the port's VectorEnv (envs/vector.py, CPU).

The narrowed program (the default ``npc_tier=-1``) against the port's own
full-width run (``npc_tier=0``), driven through the same resets, spawn draws
and actions: every NpcState field, every other state leaf and every output,
bit for bit, every step; on tests/test_npc_tier.py's cases, with the slot
and wave cleanups and the serial and fast NPC modes, and through
``final_obs``. Each narrowed run must have run both a narrowed width and,
where the pool fills, the full width, and must have read the device once
per step for it. The lockstep against the JAX package's VectorEnv is in
tests/test_torch_npc_tier_lockstep.py.
"""
import types

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.envs.vector import _tiers
from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
from marl_traffic_intersection_tpu_torch.envs.vector import npc_tier_widths

from ._torch_port import assert_bits


def _leaves(state, out):
    return {**{f"ego.{k}": v for k, v in state.ego._asdict().items()},
            **{f"npc.{k}": v for k, v in state.npc._asdict().items()},
            "lidar": state.lidar, "step_count": state.step_count,
            **{f"out.{k}": v for k, v in out._asdict().items()}}


def _run(npc_tier, density, max_npcs, steps, seed, num_envs=8, final_obs=False, **cfg):
    env = IntersectionEnv(EnvConfig(num_agents=2, traffic_flow=True, traffic_density=density,
                                    max_npcs=max_npcs, npc_tier=npc_tier,
                                    **{"max_steps": 10 ** 6, **cfg}), device="cpu")
    venv = VectorEnv(env, num_envs=num_envs, seed=seed)
    state, _ = venv.reset()
    rng = np.random.RandomState(seed + 1)
    traj = []
    for _ in range(steps):
        acts = torch.from_numpy(rng.uniform(-1, 1, (num_envs, 2, 2)).astype(np.float32))
        got = venv.step(state, acts, final_obs=final_obs)
        state, out = got[:2]
        leaves = _leaves(state, out)
        if final_obs:
            leaves["term_obs"] = got[2]
        traj.append(leaves)
    return traj, dict(env.npc_stats)


def _assert_bitwise(narrowed, full):
    assert len(narrowed) == len(full)
    for t, (a, b) in enumerate(zip(narrowed, full)):
        for name in b:
            assert_bits(name, b[name], a[name], f"step {t}")


def _assert_both_programs(stats, max_npcs, steps, pool_fills):
    narrow = sum(v for k, v in stats.items() if k.startswith("step_width_")
                 and k != f"step_width_{max_npcs}")
    full = stats.get(f"step_width_{max_npcs}", 0)
    assert narrow + full == steps and narrow > 0, stats
    if pool_fills:
        assert full > 0, stats
    assert stats["tier_reads"] == steps, stats      # one read per step, none at reset


def test_width_ladder_is_the_jax_one():
    assert npc_tier_widths(-1, 32) == [8, 16]
    for m in range(0, 41):
        for tier in (-3, -1, 0, 1, 2, 5, 8, 16, 31, 32, 33):
            want = _tiers(types.SimpleNamespace(npc_tier=tier), m)
            assert npc_tier_widths(tier, m) == want, (tier, m)


@pytest.mark.parametrize("density,max_npcs,steps,seed,cfg", [
    (1.0, 16, 120, 0, {}),                                 # narrowed nearly every tick
    (8.0, 12, 160, 1, {}),                                 # the width flips both ways
    (12.0, 8, 200, 2, {}),                                 # the head fills: full width
    (8.0, 12, 160, 1, {"npc_cleanup": "wave"}),
    (8.0, 12, 160, 1, {"npc_mode": "serial"}),
    (3.0, 16, 100, 5, {"npc_mode": "fast"}),               # tests/test_npc_tier.py:68
])
def test_narrowed_step_bit_equals_full_width(density, max_npcs, steps, seed, cfg):
    narrowed, stats = _run(-1, density, max_npcs, steps, seed, **cfg)
    full, full_stats = _run(0, density, max_npcs, steps, seed, **cfg)
    _assert_bitwise(narrowed, full)
    _assert_both_programs(stats, max_npcs, steps, pool_fills=density >= 8.0)
    assert not any(k.startswith(("step_width", "tier_reads")) for k in full_stats), full_stats


def test_narrowed_final_obs_bit_equals_full_width():
    """tests/test_npc_tier.py:95: the terminal observation of the pre-reset
    state, across the resets that max_steps=40 forces."""
    kw = dict(density=4.0, max_npcs=12, steps=90, seed=7, num_envs=6, final_obs=True,
              max_steps=40)
    narrowed, stats = _run(-1, **kw)
    full, _ = _run(0, **kw)
    _assert_bitwise(narrowed, full)
    assert sum(bool(s["out.truncated"].any()) for s in full) >= 2
    assert stats["tier_reads"] == 90 and stats.get("step_width_3", 0) > 0, stats


def test_narrowed_step_without_auto_reset_bit_equals_full_width():
    """``auto_reset=False``: the observation is built inside the narrowed step."""
    def run(npc_tier):
        env = IntersectionEnv(EnvConfig(num_agents=2, traffic_flow=True, traffic_density=8.0,
                                        max_npcs=12, npc_tier=npc_tier), device="cpu")
        venv = VectorEnv(env, num_envs=6, seed=1, auto_reset=False)
        state, _ = venv.reset()
        rng = np.random.RandomState(0)
        traj = []
        for _ in range(120):
            acts = torch.from_numpy(rng.uniform(-1, 1, (6, 2, 2)).astype(np.float32))
            state, out = venv.step(state, acts)
            traj.append(_leaves(state, out))
        return traj, dict(env.npc_stats)

    narrowed, stats = run(-1)
    _assert_bitwise(narrowed, run(0)[0])
    _assert_both_programs(stats, 12, 120, pool_fills=False)


def test_each_step_reads_the_state_it_is_given():
    """The width comes from the state passed in, in one read per step:
    stepping an earlier state again narrows as far as that state allows."""
    env = IntersectionEnv(EnvConfig(num_agents=2, traffic_flow=True, traffic_density=12.0,
                                    max_npcs=8), device="cpu")
    venv = VectorEnv(env, num_envs=4, seed=3)
    state, _ = venv.reset()
    first = state
    for _ in range(60):
        state, _ = venv.step(state, torch.zeros(4, 2, 2))
    wants = []
    for st in (first, state, first):
        alive = st.npc.alive.long()
        hi = int((alive * torch.arange(1, 9)).amax())
        full = int(alive.cumprod(1).sum(1).amax())
        wants.append(next((w for w in (2, 4) if hi <= w and full < w), 8))
        before = dict(env.npc_stats)
        venv.step(st, torch.zeros(4, 2, 2))
        assert env.npc_stats["tier_reads"] == before["tier_reads"] + 1
        key = f"step_width_{wants[-1]}"
        assert env.npc_stats[key] == before.get(key, 0) + 1, (key, env.npc_stats)
    assert wants[0] == wants[2] == 2 and wants[1] > 2, wants
