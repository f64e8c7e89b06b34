"""The plain reference follows the port's CPU path bit for bit, at a tiny
size, in both configurations: the reference's own chain from the same
reset, actions, spawn draws and routes, step by step."""
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core.env import EnvConfig, IntersectionEnv
from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv
from portbench import check
from portbench.reference import vector as ref_vector
from portbench.tests.helpers import CELLS, tiny

# short episodes, so that envs reset; with traffic two agents and a spawn
# try in every env and step, so that the NPC pool fills and the exact
# controller's cleanup rounds run
STEPS, MAX_STEPS = 110, 80


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name):
    cell = tiny(name, envs=6)
    cfg = dict(cell.env_config(), max_steps=MAX_STEPS)
    if cfg["traffic_flow"]:
        cfg["num_agents"] = 2
    ref = check.reference_env(cfg)
    env = IntersectionEnv(EnvConfig(**cfg), device="cpu")
    g = torch.Generator().manual_seed(11)
    pool = torch.as_tensor(ref_vector.route_pool(ref))
    n = cfg["num_agents"]
    drawn = {}

    def routes(b):
        drawn["routes"] = pool[torch.argsort(torch.rand((b, pool.shape[0]), generator=g),
                                             -1)[:, :n]]
        return drawn["routes"]

    def spawns(b):
        drawn["spawn"] = (torch.ones(b, dtype=torch.bool),
                          torch.randint(int(ref.traffic_ids.shape[0]), (b,), generator=g,
                                        dtype=torch.int32))
        return drawn["spawn"]

    venv = VectorEnv(env, 6, route_sampler=routes,
                     spawn_sampler=spawns if cfg["traffic_flow"] else None)
    state, obs = venv.reset()
    ref_state = ref.reset_state(drawn["routes"])
    assert check.mismatches(check.as_reference(state), ref_state) == 0
    assert check.mismatches(obs, ref.observe(ref_state)) == 0
    resets = 0
    for k in range(STEPS):
        actions = torch.randn((6, n, 2), generator=g)
        state, out = venv.step(state, actions)
        ref_state, ref_out = ref_vector.step(ref, ref_state, actions, drawn.get("spawn"),
                                             drawn["routes"])
        bad = check.grouped(check.as_reference(state), out._asdict(), ref_state,
                            ref_out._asdict())
        assert not any(bad.values()), (k, bad)
        resets += int((out.terminated | out.truncated).sum())
    assert resets > 0
    if cfg["traffic_flow"]:
        assert env.npc_stats["cleanup_rounds"] > 0 and int(state.npc.alive.sum()) > 0
