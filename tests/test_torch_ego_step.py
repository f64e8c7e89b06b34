"""K3's pieces (csrc/ego_step.cuh), built for the CPU through
csrc/ego_step_host.cpp, against the plain version core/env.py::ego_step_ref,
bit for bit, every output.

The header is the arithmetic the card runs; the card itself, with its thread
and leader composition, is held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py. Inputs (ops/ego_step_cases.py):
seeded batches at 1, 2, 4, 8 and 32 agents with 0, 8, 16 and 32 NPC slots,
the team reward and the respawn on and off, two and three lanes, step
counters at the truncation; and the edge envs: ties in the path-index
window, NaN and +-1e10 positions, +-0.0 headings, an env of dead agents, a
car 40 px short of its goal and two boxes that touch.
"""
import ctypes

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core import env as env_module
from marl_traffic_intersection_tpu_torch.core.constants import (
    STATUS_ALIVE, STATUS_CRASH_CAR, STATUS_CRASH_LINE, STATUS_CRASH_WALL, STATUS_DEAD,
    STATUS_SUCCESS)
from marl_traffic_intersection_tpu_torch.core.env import EgoTick, ego_step_ref
from marl_traffic_intersection_tpu_torch.ops import native
from marl_traffic_intersection_tpu_torch.ops import ego_step_cuda
from marl_traffic_intersection_tpu_torch.ops.ego_step_cases import (CASES, EDGE_ENVS, case_args,
                                                                    nan_as_one)

from ._torch_port import assert_bits


def _host() -> ctypes.CDLL:
    lib = native.load("ego_step_host.cpp")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.ego_step_host.argtypes = [p, p, p, ctypes.c_int, ctypes.c_long]
        lib.ego_step_host.restype = ctypes.c_int
        lib._typed = True
    return lib


def host_tick(args) -> EgoTick:
    """The header's tick on ego_step_ref's arguments (CPU tensors)."""
    ego, actions, dt, step_count, tables, npc, cfg, reward, max_progress = args
    B, n = ego.x.shape
    f = torch.empty((9, B, n), dtype=torch.float32)
    i = torch.empty((2, B, n), dtype=torch.int32)
    done = torch.empty((B, n), dtype=torch.bool)
    env_i = torch.empty((2, B), dtype=torch.int32)
    env_b = torch.empty((2, B), dtype=torch.bool)
    slots = None if npc is None else (npc.x, npc.y, npc.heading, npc.alive)
    tensors, ld = ego_step_cuda.pointers(ego, actions, dt, step_count, tables, slots,
                                         (f, i, done, env_i, env_b))
    w = 0 if npc is None else npc.x.shape[1]
    ints, floats = ego_step_cuda.params(cfg, reward, max_progress, n, w, tables.paths.shape[0])
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    assert _host().ego_step_host(ptrs, ints.ctypes.data, floats.ctypes.data, B, ld) == 0
    x, y, v, h, steering, prev_dist, prev_acc, prev_steer, rew = f
    new = ego._replace(x=x, y=y, v=v, heading=h, steering_angle=steering, path_index=i[0],
                       prev_dist_to_goal=prev_dist, prev_acc_norm=prev_acc,
                       prev_steer_norm=prev_steer)
    return EgoTick(ego=new, reward=rew, done=done, status=i[1], agents_alive=env_i[0],
                   step_count=env_i[1], terminated=env_b[0], truncated=env_b[1])


def assert_ticks_equal(want: EgoTick, got: EgoTick, where: str = "") -> None:
    pairs = [(f"ego.{k}", getattr(want.ego, k), getattr(got.ego, k)) for k in want.ego._fields]
    pairs += [(k, getattr(want, k), getattr(got, k)) for k in EgoTick._fields[1:]]
    for name, a, b in pairs:
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert_bits(name, nan_as_one(a), nan_as_one(b), where)


@pytest.mark.parametrize("name", list(CASES))
def test_host_tick_matches_the_plain_version(name):
    args = case_args(name)
    want, got = ego_step_ref(*args), host_tick(args)
    assert_ticks_equal(want, got, name)
    if name == "edges":
        e = {k: i for i, k in enumerate(EDGE_ENVS)}
        # the ties: half-way between points 60 and 61, 140 and 141, the lower
        assert got.ego.path_index[e["tie"], :2].tolist() == [60, 140]
        assert got.ego.heading[e["tie"]].view(torch.int32).tolist()[:3] == [0, 0, -2 ** 31]
        assert got.status[e["tie"], 3] == STATUS_ALIVE         # 40 px short of the goal
        assert got.status[e["touching"]].tolist() == [STATUS_CRASH_CAR] * 2 + [STATUS_ALIVE,
                                                                               STATUS_DEAD]
        # a NaN position takes the window's first point
        assert got.ego.path_index[e["nan"], :3].tolist() == \
            args[0].path_index[e["nan"], :3].clamp_min(0).tolist()
        # on the CPU a NaN corner truncates to INT32_MIN, off the line mask
        assert got.status[e["nan on the line mask"], 0] == STATUS_ALIVE
        assert got.status[e["all dead"]].tolist() == [STATUS_DEAD] * 4
        # without respawn a dead agent is done, and an env with a done agent
        # terminates
        assert got.agents_alive[e["all dead"]] == 0 and got.terminated[e["all dead"]]


def test_the_cases_reach_every_status_and_episode_end():
    seen, ends = set(), set()
    for name in ("n4", "n8 w16 team", "n4 team no-respawn"):
        got = ego_step_ref(*case_args(name))
        seen |= set(got.status.flatten().tolist())
        ends |= {("terminated", bool(t)) for t in got.terminated.tolist()}
        ends |= {("truncated", bool(t)) for t in got.truncated.tolist()}
    assert seen == {STATUS_ALIVE, STATUS_DEAD, STATUS_SUCCESS, STATUS_CRASH_WALL,
                    STATUS_CRASH_LINE, STATUS_CRASH_CAR}
    assert ends == {(k, v) for k in ("terminated", "truncated") for v in (False, True)}


def test_ego_step_takes_the_plain_version_on_the_cpu_and_the_kernel_refuses_it():
    args = case_args("n8 w8")
    native.reset_launches()
    assert_ticks_equal(ego_step_ref(*args), env_module.ego_step(*args))
    assert native.LAUNCHES["ego_step"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ego_step_cuda.ego_step(*args)


def test_pointers_refuse_what_the_kernel_does_not_take():
    ego, actions, dt, step_count, tables, npc, *_ = case_args("n2 w8 team no-respawn", envs=4)
    outs = (torch.empty(1),) * 5
    slots = (npc.x, npc.y, npc.heading, npc.alive)
    with pytest.raises(ValueError, match="x must be"):
        ego_step_cuda.pointers(ego._replace(x=ego.x.double()), actions, dt, step_count,
                               tables, slots, outs)
    with pytest.raises(ValueError, match="actions must be contiguous"):
        ego_step_cuda.pointers(ego, actions.transpose(0, 1).contiguous().transpose(0, 1),
                               dt, step_count, tables, slots, outs)
    with pytest.raises(ValueError, match="npc alive"):
        ego_step_cuda.pointers(ego, actions, dt, step_count, tables,
                               slots[:3] + (slots[3].to(torch.uint8),), outs)
    wide = [torch.cat([t, t], 1) for t in slots]
    with pytest.raises(ValueError, match="npc y must have"):
        ego_step_cuda.pointers(ego, actions, dt, step_count, tables,
                               (wide[0][:, :8],) + slots[1:], outs)
    tensors, ld = ego_step_cuda.pointers(ego, actions, dt, step_count, tables,
                                         tuple(t[:, :8] for t in wide), outs)
    assert ld == 16 and tensors[19].data_ptr() == wide[0].data_ptr()
    assert np.asarray(ego_step_cuda.params(case_args("n4")[6], case_args("n4")[7], 1.0, 4, 0,
                                           144)[0]).tolist() == [4, 0, 144, 3, 50, 0, 1]
