"""The port's native host engine (csrc/engine.cpp, native/host.py): the
source is the JAX package's byte for byte, its outputs are the JAX package's
NativeEngine's on the same seed and actions, and it keeps step with the
port's core within tests/test_native.py's tolerances (the engine's own float
chain differs from the reference's in places, so that file holds it within
tolerances too)."""
import time

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.native import NativeEngine as JaxNativeEngine
from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv
from marl_traffic_intersection_tpu_torch.native import NativeEngine, native_available
from marl_traffic_intersection_tpu_torch.native import host

from ._torch_port import ROOT, port_env

ROUTES = {"single": [("IN_6", "OUT_2")],
          "team": [("IN_1", "OUT_7"), ("IN_7", "OUT_1"), ("IN_4", "OUT_7")]}


def test_engine_source_is_the_jax_packages_byte_for_byte():
    jax_src = ROOT / "marl_traffic_intersection_tpu" / "native" / "engine.cpp"
    assert host._SRC.read_bytes() == jax_src.read_bytes()
    assert host._SRC.parent == ROOT / "marl_traffic_intersection_tpu_torch" / "csrc"
    assert native_available()
    lib = host.library_path()
    assert lib.exists() and lib.parent == ROOT / "marl_traffic_intersection_tpu_torch" / "_build"


def _pol(rng, n):
    return np.stack([rng.choice([0.0, 0.5, 1.0, -0.5], n),
                     np.clip(rng.normal(0, 0.4, n), -1, 1)], axis=1).astype(np.float32)


@pytest.mark.parametrize("case,traffic,inject", [("single", False, False), ("team", False, False),
                                                 ("single", True, False), ("single", True, True)])
def test_outputs_equal_the_jax_engines(case, traffic, inject):
    """Same configuration, seed and actions: every output and every read-back
    of the port's engine equals the JAX package's, bit for bit."""
    routes = ROUTES[case]
    env = port_env(len(routes))
    rids = [int(r) for r in env.table.route_ids(routes)]
    kw = dict(use_team=case == "team", traffic=traffic, density=20.0, seed=5, max_steps=4000)
    engines = [NativeEngine(**kw), JaxNativeEngine(**kw)]
    for e in engines:
        e.reset(rids)
    np.testing.assert_array_equal(engines[0].observations(), engines[1].observations())
    rng = np.random.RandomState(3)
    T = env.table.traffic_route_ids.shape[0]
    npcs = 0
    for t in range(250):
        a = _pol(rng, len(routes))
        spawn = (bool(rng.uniform() < 0.2), int(rng.randint(T))) if inject else None
        got, want = (e.step(a, spawn=spawn) for e in engines)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} at step {t}")
        np.testing.assert_array_equal(engines[0].egos(), engines[1].egos())
        np.testing.assert_array_equal(engines[0].npcs(), engines[1].npcs())
        for i in range(len(routes)):
            np.testing.assert_array_equal(engines[0].lidar(i), engines[1].lidar(i))
        npcs += len(engines[0].npcs())
    assert (npcs > 0) == traffic
    np.testing.assert_array_equal(engines[0].route_table(), engines[1].route_table())


@pytest.mark.parametrize("case,traffic", [("single", False), ("team", False), ("single", True)])
def test_keeps_step_with_the_ports_core(case, traffic):
    """The tolerances of tests/test_native.py: status, done, terminated and
    truncated equal; rewards within 1e-4, the first 31 obs within 5e-5, no
    lidar reading off by more than two samples; with traffic, the NPCs' x
    within 5e-3 and their path indices equal."""
    routes = ROUTES[case]
    n = len(routes)
    env = port_env(n, traffic_flow=traffic, use_team_reward=case == "team", max_steps=4000)
    rids = env.table.route_ids(routes)
    state, _ = env.reset(rids)
    nat = NativeEngine(use_team=case == "team", traffic=traffic, max_steps=4000)
    nat.reset([int(r) for r in rids])
    rng = np.random.RandomState(9)
    T = env.table.traffic_route_ids.shape[0]
    for t in range(200):
        a = _pol(rng, n)
        spawn = None
        if traffic:
            do_try, rc = bool(rng.uniform() < 0.2) or (t % 25 == 3), int(rng.randint(T))
            spawn = (torch.tensor([do_try]), torch.tensor([rc], dtype=torch.int32))
        state, out = env.step(state, torch.from_numpy(a)[None], spawn=spawn)
        ref = nat.step(a, spawn=(do_try, rc) if traffic else None)
        assert np.array_equal(out.status[0].numpy(), ref["status"]), t
        assert np.array_equal(out.done[0].numpy().astype(np.int32), ref["done"]), t
        assert bool(out.terminated[0]) == ref["terminated"]
        assert bool(out.truncated[0]) == ref["truncated"]
        np.testing.assert_allclose(out.reward[0].numpy(), ref["reward"], atol=1e-4, rtol=0)
        mine = out.obs[0].numpy()
        np.testing.assert_allclose(mine[:, :31], ref["obs"][:, :31], atol=5e-5, rtol=0)
        assert (np.abs(mine[:, 31:] - ref["obs"][:, 31:]) > 8.0 / 250.0 + 1e-6).sum() == 0, t
        if traffic:
            refn = nat.npcs()
            alive, uid = state.npc.alive[0].numpy(), state.npc.uid[0].numpy()
            idx = np.nonzero(alive)[0]
            idx = idx[np.argsort(uid[idx])]
            assert len(idx) == refn.shape[0], t
            np.testing.assert_allclose(state.npc.x[0].numpy()[idx], refn[:, 0], atol=5e-3)
            assert np.array_equal(state.npc.path_index[0].numpy()[idx], refn[:, 4].astype(int))


def test_native_gym_backend_answers_the_whole_api():
    """backend='native': reset returns the native engine's own first
    observation, the next steps keep step with the port's engine backend,
    and the renderer draws the native state."""
    cfg = {"num_agents": 3, "seed": 7, "device": "cpu", "render_mode": "rgb_array"}
    nat = GymIntersectionEnv({**cfg, "backend": "native"})
    eng = GymIntersectionEnv(cfg)
    for trial in range(2):
        obs_n, _ = nat.reset(seed=trial)
        obs_e, _ = eng.reset(seed=trial)
        assert obs_n.shape == obs_e.shape == (3, 127)
        np.testing.assert_allclose(obs_n[:, :31], obs_e[:, :31], atol=5e-5, rtol=0)
        np.testing.assert_allclose(obs_n[:, 31:], obs_e[:, 31:], atol=1e-6, rtol=0)
        for _ in range(20):
            acts = np.tile(np.float32([0.5, 0.1]), (3, 1))
            on, rn, _, _, in_ = nat.step(acts)
            oe, re, _, _, ie = eng.step(acts)
            np.testing.assert_allclose(on[:, :31], oe[:, :31], atol=5e-5, rtol=0)
            np.testing.assert_allclose(rn, re, atol=1e-4, rtol=0)
            assert in_["status"] == ie["status"] and set(in_) == set(ie)
    assert nat.render().shape == (750, 750, 3)
    assert [c.state.x for c in nat.env.cars] == pytest.approx([c.state.x for c in eng.env.cars],
                                                              abs=1e-3)


def test_native_latency_sane():
    nat = NativeEngine()
    nat.reset([61])
    a = np.zeros((1, 2), np.float32)
    nat.step(a)
    t0 = time.perf_counter()
    for _ in range(2000):
        nat.step(a)
    assert (time.perf_counter() - t0) / 2000 < 2e-3
