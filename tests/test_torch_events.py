"""The port's GLFW-style event surface (envs/events.py) and the raw attribute
surface of its GymIntersectionEnv: the counterparts of tests/test_events.py,
on the CPU."""
import numpy as np

from marl_traffic_intersection_tpu.envs import events as jax_events
from marl_traffic_intersection_tpu_torch.envs import events
from marl_traffic_intersection_tpu_torch.envs.events import (KEY_DOWN, KEY_ESCAPE, KEY_UP,
                                                             EventSurface, _glfw_code)
from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv


def test_keycodes_are_the_jax_packages():
    for name in ("KEY_ESCAPE", "KEY_RIGHT", "KEY_LEFT", "KEY_DOWN", "KEY_UP", "_MPL_TO_GLFW"):
        assert getattr(events, name) == getattr(jax_events, name)
    for key in ("up", "escape", "r", "R", "f1", None):
        assert _glfw_code(key) == jax_events._glfw_code(key)


def test_surface_press_poll_release():
    s = EventSurface()
    assert not s.key_pressed(KEY_UP)
    s.inject_press(KEY_UP)
    assert not s.key_pressed(KEY_UP)          # not visible until polled
    s.poll_events()
    assert s.key_pressed(KEY_UP)
    s.poll_events()
    assert s.key_pressed(KEY_UP)              # held across polls until released
    s.inject_release(KEY_UP)
    s.poll_events()
    assert not s.key_pressed(KEY_UP)


def test_surface_close_and_printable_keys():
    s = EventSurface()
    assert not s.window_should_close()
    s.request_close()
    assert s.window_should_close()
    s.inject_press(ord("R"))
    s.poll_events()
    assert s.key_pressed(ord("R")) and not s.key_pressed(ord("L"))


def test_reference_harness_idiom_on_gym_env():
    """The access pattern of the reference's test.py drive loop."""
    env = GymIntersectionEnv({"num_agents": 1, "device": "cpu"})
    env.env.inject_press(KEY_UP)
    env.env.poll_events()
    assert not env.env.window_should_close()
    throttle = 0.3 if env.env.key_pressed(KEY_UP) else \
        -0.5 if env.env.key_pressed(KEY_DOWN) else 0.0
    assert throttle == 0.3
    obs, rew, term, trunc, info = env.step(np.array([throttle, 0.0], np.float32))
    assert obs.shape == (1, 127)
    env.env.inject_press(KEY_ESCAPE)
    env.env.poll_events()
    assert env.env.key_pressed(KEY_ESCAPE)


def test_raw_attribute_surface():
    """`env.env.cars` / `.traffic_cars` / `.lidars` / `.step_count`
    (cpp/bindings.cpp:66-70), as per-read snapshots."""
    env = GymIntersectionEnv({"num_agents": 2, "device": "cpu",
                              "ego_routes": [("IN_6", "OUT_2"), ("IN_1", "OUT_7")]})
    assert env.env.step_count == 0
    cars = env.env.cars
    assert len(cars) == 2
    t = env._core.table
    rid = t.route_id("IN_6", "OUT_2")
    assert cars[0].state.x == float(t.spawn_xy[rid, 0])
    assert cars[0].state.y == float(t.spawn_xy[rid, 1])
    assert cars[0].state.heading == float(t.spawn_heading[rid])
    assert cars[0].alive and cars[0].path_index == 0 and len(cars[0].path) == 160
    assert env.env.traffic_cars == []
    lidars = env.env.lidars
    assert len(lidars) == 2 and lidars[0].rays == 96 and lidars[0].max_dist == 250.0
    assert all(d == 250.0 for d in lidars[0].distances)
    env.step(np.full((2, 2), 0.5, np.float32))
    assert env.env.step_count == 1
    assert env.env.cars[0].state.v > 0.0 and cars[0].state.v == 0.0
    assert any(d < 250.0 for d in env.env.lidars[0].distances)


def test_raw_attribute_surface_traffic():
    """traffic_cars materializes the alive NPCs in spawn order."""
    env = GymIntersectionEnv({"traffic_flow": True, "traffic_density": 50.0, "seed": 3,
                              "device": "cpu"})
    for _ in range(60):
        env.step(np.array([0.0, 0.0], np.float32))
    tc = env.env.traffic_cars
    assert len(tc) >= 1
    uid = env.state.npc.uid[0].numpy()
    alive = env.state.npc.alive[0].numpy()
    order = np.nonzero(alive)[0][np.argsort(uid[alive], kind="stable")]
    assert [c.state.x for c in tc] == [float(env.state.npc.x[0, i]) for i in order]
    for c in tc:
        assert c.alive and len(c.path) == 160
