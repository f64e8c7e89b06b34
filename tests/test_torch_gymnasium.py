"""The port's strict Gymnasium adapters (envs/gymnasium_compat.py): the
counterparts of tests/test_gymnasium_compat.py on the CPU, and their
observations against the port's own env."""
import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

from marl_traffic_intersection_tpu_torch.envs.gymnasium_compat import (  # noqa: E402
    GymnasiumIntersectionEnv, GymnasiumVectorEnv)

from ._torch_port import port_env  # noqa: E402

CPU = {"device": "cpu"}


def test_env_checker_passes():
    from gymnasium.utils.env_checker import check_env
    check_env(GymnasiumIntersectionEnv({"max_steps": 64, **CPU}), skip_render_check=True)


def test_single_env_episode_is_the_ports_env():
    env = GymnasiumIntersectionEnv({"max_steps": 50, "ego_routes": [("IN_6", "OUT_2")], **CPU})
    core = port_env(1, max_steps=50)
    state, want = core.reset(core.table.route_ids([("IN_6", "OUT_2")]))
    obs, info = env.reset(seed=3)
    assert obs.shape == (127,) and obs.dtype == np.float32
    np.testing.assert_array_equal(obs, want[0, 0].numpy())
    for _ in range(50):
        obs, rew, term, trunc, info = env.step(np.array([0.5, 0.0], np.float32))
        state, out = core.step(state, torch.tensor([[[0.5, 0.0]]]))
        np.testing.assert_array_equal(obs, out.obs[0, 0].numpy())
        assert rew == float(out.reward[0, 0]) and "status" in info
        if term or trunc:
            break
    assert term or trunc


def test_traffic_single_env_steps():
    env = GymnasiumIntersectionEnv({"traffic_flow": True, "traffic_density": 50.0, **CPU})
    env.reset(seed=0)
    for _ in range(40):
        obs, *_ = env.step(np.zeros(2, np.float32))
    assert obs.shape == (127,) and bool(env._state.npc.alive.any())


def test_multi_agent_rejected():
    with pytest.raises(ValueError, match="single-agent"):
        GymnasiumIntersectionEnv({"num_agents": 3, **CPU})
    with pytest.raises(ValueError, match="single-agent"):
        GymnasiumVectorEnv(4, {"num_agents": 2, **CPU})


def test_render_rgb_array():
    env = GymnasiumIntersectionEnv({"max_steps": 16, **CPU}, render_mode="rgb_array")
    env.reset(seed=0)
    frame = env.render()
    assert frame.shape == (750, 750, 3)


def test_vector_env_shapes_and_autoreset():
    venv = GymnasiumVectorEnv(8, {"max_steps": 12, **CPU}, seed=0)
    obs, info = venv.reset()
    assert obs.shape == (8, 127)
    assert venv.observation_space.shape == (8, 127) and venv.action_space.shape == (8, 2)
    saw_trunc = False
    for _ in range(16):
        obs, rew, term, trunc, info = venv.step(np.zeros((8, 2), np.float32))
        assert obs.shape == (8, 127) and rew.shape == (8,)
        assert term.shape == (8,) and trunc.shape == (8,)
        saw_trunc |= bool(trunc.any())
    assert saw_trunc and np.isfinite(obs).all()


def test_vector_env_gymnasium_wrapper_compat():
    venv = GymnasiumVectorEnv(4, {"max_steps": 16, **CPU}, seed=1)
    wrapped = gymnasium.wrappers.vector.RecordEpisodeStatistics(venv)
    obs, info = wrapped.reset()
    for _ in range(4):
        obs, rew, term, trunc, info = wrapped.step(np.zeros((4, 2), np.float32))
    assert obs.shape == (4, 127)


def test_vector_env_same_step_final_obs():
    """SAME_STEP: finished episodes put their terminal observation in
    infos['final_obs'] (the returned obs is the post-reset one), in
    SyncVectorEnv's object-array + mask layout."""
    venv = GymnasiumVectorEnv(4, {"max_steps": 6, **CPU}, seed=2)
    assert venv.metadata["autoreset_mode"] == gymnasium.vector.AutoresetMode.SAME_STEP
    obs, info = venv.reset(seed=5)
    final_seen = False
    for _ in range(8):
        obs, rew, term, trunc, infos = venv.step(np.zeros((4, 2), np.float32))
        done = term | trunc
        if done.any():
            final_seen = True
            assert set(infos) >= {"final_obs", "_final_obs", "final_info", "_final_info"}
            np.testing.assert_array_equal(infos["_final_obs"], done)
            for i in range(4):
                if done[i]:
                    assert infos["final_obs"][i].shape == (127,)
                    assert not np.array_equal(infos["final_obs"][i], obs[i])
                else:
                    assert infos["final_obs"][i] is None
        else:
            assert infos == {}
    assert final_seen
