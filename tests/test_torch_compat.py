"""The port's object-level reference-API layer (compat.py) against the JAX
package's (tests/test_compat.py) and the port's own functional kernels.

``Car.update`` takes its trig from ops/libm.py, never numpy (ROADMAP queue 3,
H12: numpy's float32 sin/cos/tan differ from glibc's on 11-23% of inputs),
so its trig values are held against ``jnp``'s, which equal glibc, and shown
to differ from numpy's on that run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu.compat import Car as JaxCar
from marl_traffic_intersection_tpu.compat import Lidar as JaxLidar
from marl_traffic_intersection_tpu.compat import State as JaxState
from marl_traffic_intersection_tpu.core.physics import car_physics_step as jax_physics
from marl_traffic_intersection_tpu_torch.compat import (Car, Lidar, RewardConfig, State,
                                                        StepResult, host_state)
from marl_traffic_intersection_tpu_torch.core.physics import car_physics_step
from marl_traffic_intersection_tpu_torch.ops import libm

from ._torch_port import port_env


def test_reference_api_constructs():
    s = State()
    assert (s.x, s.y, s.v, s.heading) == (0.0, 0.0, 0.0, 0.0)
    car = Car()
    assert car.alive and car.length == 54.0 and car.width == 24.0
    rc = RewardConfig()
    assert (rc.k_prog, rc.v_min_ms, rc.k_stuck, rc.k_cv, rc.k_co, rc.k_succ,
            rc.k_sm, rc.alpha) == (10.0, 1.0, -0.01, -10.0, -5.0, 10.0, -0.02, 0.2)
    sr = StepResult()
    assert sr.step == 0 and not sr.terminated and sr.obs.shape == (0, 127)
    ld = Lidar()
    assert ld.rays == 72 and ld.max_dist == 250.0
    assert len(ld.distances) == 72 and len(ld.rel_angles) == 72
    assert ld.rel_angles == JaxLidar().rel_angles
    env = Lidar.env_sensor()
    assert env.rays == 96 and env.fov_deg == 360.0 and env.max_dist == 250.0


def test_car_update_matches_the_kernel_and_its_trig_is_glibc(monkeypatch):
    """500 random control steps: the Car tracks the port's car_physics_step
    float for float; every tanf/cosf/sinf it took equals jnp's (glibc's) on
    the same input, where numpy's float32 trig differs on some of them."""
    seen = []
    glibc_np = libm.glibc_np

    def spy(name, x):
        out = glibc_np(name, x)
        seen.append((name, np.float32(x[0]), out[0]))
        return out

    monkeypatch.setattr(libm, "glibc_np", spy)
    rng = np.random.RandomState(0)
    car = Car()
    car.state = State(x=100.0, y=700.0, v=0.0, heading=1.25)
    t = lambda v: torch.tensor(np.float32(v))
    x, y, v, h, st = t(100.0), t(700.0), t(0.0), t(1.25), t(0.0)
    for i in range(500):
        th = float(rng.choice([0.0, 0.5, 1.0, -0.5, 0.123]))
        sr = float(np.clip(rng.normal(0, 0.5), -1, 1))
        car.update(th, sr, 1.0 / 60.0)
        out = car_physics_step(x, y, v, h, st, t(th), t(sr), t(1.0 / 60.0))
        x, y, v, h, st = out.x, out.y, out.v, out.heading, out.steering_angle
        got = [np.float32(a) for a in (car.state.x, car.state.y, car.state.v,
                                       car.state.heading, car.steering_angle)]
        want = [a.numpy() for a in (x, y, v, h, st)]
        assert [g.view(np.int32) for g in got] == [w.view(np.int32) for w in want], i
    assert len(seen) >= 1000
    jfn = {"tanf": jnp.tan, "cosf": jnp.cos, "sinf": jnp.sin}
    npfn = {"tanf": np.tan, "cosf": np.cos, "sinf": np.sin}
    numpy_off = 0
    for name, arg, val in seen:
        assert np.float32(jfn[name](arg)).view(np.int32) == val.view(np.int32), (name, arg)
        numpy_off += int(npfn[name](arg, dtype=np.float32) != val)
    assert numpy_off > 0


def test_car_update_matches_the_jax_car_and_kernel():
    """The same 300 steps through the JAX package's functional step: the
    port's Car lands on the same poses bit for bit."""
    rng = np.random.RandomState(1)
    car = Car()
    car.state = State(x=300.0, y=650.0, v=0.5, heading=1.5)
    j = dict(x=jnp.float32(300.0), y=jnp.float32(650.0), v=jnp.float32(0.5),
             heading=jnp.float32(1.5), steering_angle=jnp.float32(0.0))
    step = jax.jit(jax_physics)
    for i in range(300):
        th = float(rng.choice([0.0, 0.5, 1.0, -0.5]))
        sr = float(np.clip(rng.normal(0, 0.6), -1, 1))
        car.update(th, sr, 1.0 / 60.0)
        out = step(j["x"], j["y"], j["v"], j["heading"], j["steering_angle"],
                   jnp.float32(th), jnp.float32(sr), jnp.float32(1.0 / 60.0))
        j = dict(x=out.x, y=out.y, v=out.v, heading=out.heading,
                 steering_angle=out.steering_angle)
        assert np.float32(car.state.x) == np.asarray(out.x), i
        assert np.float32(car.state.y) == np.asarray(out.y), i
        assert np.float32(car.state.heading) == np.asarray(out.heading), i


def test_car_collision_and_corners_match_jax():
    cases = [((100.0, 100.0, 0.0), (140.0, 100.0, 0.5)), ((100.0, 100.0, 0.0),
                                                          (400.0, 400.0, 0.0)),
             ((300.0, 300.0, 1.0), (330.0, 320.0, -2.0)), ((300.0, 300.0, 0.3),
                                                           (352.0, 300.0, 0.3))]
    for a, b in cases:
        pa, pb, ja, jb = Car(), Car(), JaxCar(), JaxCar()
        pa.state, pb.state = State(x=a[0], y=a[1], heading=a[2]), State(x=b[0], y=b[1],
                                                                         heading=b[2])
        ja.state, jb.state = JaxState(x=a[0], y=a[1], heading=a[2]), JaxState(x=b[0], y=b[1],
                                                                              heading=b[2])
        assert pa.check_collision(pb) == ja.check_collision(jb) == pb.check_collision(pa)
        assert pa.corners().shape == (4, 2)
        np.testing.assert_array_equal(pa.corners().view(np.int32),
                                      np.asarray(ja.corners()).view(np.int32))
    assert Car().check_collision(Car())       # two cars on one pose overlap


def test_car_path_following_matches_the_env():
    """A Car loaded from an EnvState slot + update/update_path_index
    reproduces the env's own next pose and path index (config 1, mid-route)."""
    env = port_env(1)
    state, _ = env.reset(env.table.route_ids([("IN_6", "OUT_2")]))
    acts = torch.tensor([[[0.7, 0.05]]])
    for _ in range(30):
        state, _ = env.step(state, acts)
    car = Car.from_env_state(state, 0, paths=env.table.paths)
    assert len(car.path) == 160
    car.update(0.7, 0.05, 1.0 / 60.0)
    car.update_path_index()
    state2, _ = env.step(state, acts)
    assert np.float32(car.state.x) == state2.ego.x[0, 0].numpy()
    assert np.float32(car.state.y) == state2.ego.y[0, 0].numpy()
    assert np.float32(car.state.heading) == state2.ego.heading[0, 0].numpy()
    assert car.path_index == int(state2.ego.path_index[0, 0])
    car.spawn_state = State(x=1.0, y=2.0)
    car.respawn()
    assert dataclasses.astuple(car.state) == (1.0, 2.0, 0.0, 0.0) and car.path_index == 0


def test_host_state_moves_one_env_to_numpy():
    env = port_env(2)
    state, _ = env.reset(num_envs=3)
    h = host_state(state, env=2)
    assert h.ego.x.shape == (2,) and h.lidar.shape == (2, 96) and h.npc.alive.shape == (0,)
    assert host_state(h) is h


def test_standalone_lidar_matches_jax():
    """The 72-ray standalone sensor and the env's 96-ray one, against the
    road and other cars, equal the JAX package's compat Lidar."""
    poses = [(375.0, 375.0, 0.0), (475.0, 375.0, 0.0), (420.0, 300.0, 1.2),
             (100.0, 400.0, 3.0)]
    for make in (lambda m: m(), lambda m: m.env_sensor()):
        cars, jcars = [], []
        for x, y, h in poses:
            c, jc = Car(), JaxCar()
            c.state, jc.state = State(x=x, y=y, heading=h), JaxState(x=x, y=y, heading=h)
            cars.append(c)
            jcars.append(jc)
        ld, jd = make(Lidar), make(JaxLidar)
        for i in range(len(cars)):
            ld.update(cars[i], cars)
            jd.update(jcars[i], jcars)
            assert ld.distances == jd.distances, (ld.rays, i)
        assert min(ld.distances) < 250.0
    me = Car()
    me.state = State(x=375.0, y=375.0)
    ld = Lidar()
    ld.update(me, [me])
    d0 = list(ld.distances)
    other = Car()
    other.state = State(x=475.0, y=375.0)
    ld.update(me, [me, other])
    fwd = ld.rel_angles.index(min(ld.rel_angles, key=abs))
    assert ld.distances[fwd] < d0[fwd] and ld.distances[fwd] <= 100.0
    assert abs(ld.normalized()[fwd] - ld.distances[fwd] / 250.0) < 1e-6
