"""Physics of the port against the JAX package, bit for bit.

A 2000-step closed loop: the pose integrator under seeded random actions,
steering the car back toward the canvas centre, from each BASELINE single-env
spawn; then SAT overlap and the path-index update on seeded batches.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core import physics as jp
from marl_traffic_intersection_tpu_torch.core import physics as pp
from marl_traffic_intersection_tpu_torch.core.routes import build_route_table

from ._torch_port import EXACT_COMPILE, assert_bits


@pytest.mark.parametrize("route", [("IN_6", "OUT_2"), ("IN_1", "OUT_7")])
def test_closed_loop_trajectory_2000_steps(route):
    table = build_route_table(3)
    r = table.route_id(*route)
    x, y = (np.float32(v) for v in table.spawn_xy[r])
    h = np.float32(table.spawn_heading[r])
    v = s = np.float32(0.0)
    dt = np.float32(1.0 / 60.0)
    step = jax.jit(functools.partial(jp.car_physics_step, exact_acc=True)).lower(
        *([jnp.float32(0)] * 7), dt).compile(compiler_options=EXACT_COMPILE)
    rng = np.random.RandomState(0)
    jstate = pstate = (x, y, v, h, s)
    traj_j, traj_p = [], []
    for t in range(2000):
        jx, jy = (float(a) for a in jstate[:2])
        # closed loop: steer toward the centre with noise, random throttle
        want = np.arctan2(-(375.0 - jy), 375.0 - jx)
        err = (want - float(jstate[3]) + np.pi) % (2 * np.pi) - np.pi
        thr = np.float32(rng.choice([0.0, 0.3, 1.0, -0.5]))
        st = np.float32(np.clip(err + rng.normal(0, 0.3), -1, 1))
        o = step(*jstate, thr, st, dt)
        jstate = tuple(np.asarray(a) for a in o[:5])
        q = pp.car_physics_step(*(torch.tensor(a) for a in pstate), torch.tensor(thr),
                                torch.tensor(st), torch.tensor(dt))
        pstate = tuple(a.numpy() for a in q[:5])
        traj_j.append(jstate + (np.asarray(o.acc),))
        traj_p.append(pstate + (q.acc.numpy(),))
    assert_bits("trajectory", np.asarray(traj_j, np.float32), np.asarray(traj_p, np.float32))


def test_car_corners_and_sat_overlap():
    rng = np.random.RandomState(1)
    n = 4096
    xa, ya = (rng.uniform(300, 450, n).astype(np.float32) for _ in range(2))
    xb, yb = xa + rng.uniform(-60, 60, n).astype(np.float32), ya + rng.uniform(-60, 60, n).astype(np.float32)
    ha, hb = (rng.uniform(-np.pi, np.pi, n).astype(np.float32) for _ in range(2))
    ca, cb = jp.car_corners(xa, ya, ha), jp.car_corners(xb, yb, hb)
    j = np.asarray(jp.sat_overlap(ca, ha, cb, hb))
    t = [torch.from_numpy(a) for a in (xa, ya, ha, xb, yb, hb)]
    pa, pb = pp.car_corners(*t[:3]), pp.car_corners(*t[3:])
    assert_bits("corners", np.asarray(ca), pa)
    p = pp.sat_overlap(pa, t[2], pb, t[5]).numpy()
    assert (j == p).all() and 0.05 < p.mean() < 0.95


def test_update_path_index():
    table = build_route_table(3)
    rng = np.random.RandomState(2)
    n = 2048
    rid = rng.randint(0, table.paths.shape[0], n)
    paths = table.paths[rid]
    pi0 = rng.randint(0, 160, n).astype(np.int32)
    k = np.clip(pi0 + rng.randint(0, 30, n), 0, 159)
    x = (paths[np.arange(n), k, 0] + rng.normal(0, 5, n)).astype(np.float32)
    y = (paths[np.arange(n), k, 1] + rng.normal(0, 5, n)).astype(np.float32)
    j = np.asarray(jp.update_path_index(paths, 160, pi0, x, y))
    p = pp.update_path_index(torch.from_numpy(paths), 160, torch.from_numpy(pi0),
                             torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert (j == p).all()


def test_wrap_angle():
    a = np.random.RandomState(3).uniform(-20, 20, 100_000).astype(np.float32)
    assert_bits("wrap", np.asarray(jax.jit(jp.wrap_angle)(a)), pp.wrap_angle(torch.from_numpy(a)))
