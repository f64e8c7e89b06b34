"""K3 wrapper: the ego tick (csrc/ego_step.cu).

Replaces no TPU kernel (the JAX package steps its egos in XLA). On the card,
``IntersectionEnv.step`` calls ``ego_step`` for sections 2-7 of every step:
the ego physics, path index and base reward, the per-ego status, the ordered
ego-ego and ego-NPC collisions, the bonuses and team mix, the respawn and the
env's termination and truncation, in one launch in place of ~420-530. The
plain version, which the CPU runs and the tests and chip_smoke.py hold the
kernel to, is core/env.py::ego_step_ref. The library is built with nvcc and
loaded at first use; a CPU tensor, or anything else the kernel does not take,
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import PATH_LEN
from . import native

_SOURCE = "ego_step.cu"
MAX_AGENTS = 32       # an env's agents are one 32-bit mask (csrc/ego_step.cuh)


def _lib() -> ctypes.CDLL:
    lib = native.load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.ego_step_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_long, p]
        lib.ego_step_launch.restype = ctypes.c_int
        lib.ego_step_envs_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ego_step_envs_per_block.restype = ctypes.c_int
        lib._typed = True
    return lib


def params(config, reward, max_progress: float, n: int, w: int, routes: int) -> tuple:
    """csrc/ego_step.cuh's Params as ``(ints, floats)`` numpy arrays: the
    configuration's flags and the reward's parameters as float32, which is
    how the plain version's tensor arithmetic takes them."""
    f32 = np.float32
    ints = np.asarray([n, w, routes, config.num_lanes, config.max_steps,
                       int(config.use_team_reward and n > 0), int(config.respawn_enabled)],
                      np.int32)
    floats = np.asarray([reward.k_prog, reward.v_min_ms, reward.k_stuck, reward.k_cv,
                         reward.k_co, reward.k_succ, reward.k_sm, reward.alpha,
                         f32(1.0) - f32(reward.alpha), max_progress], f32)
    return ints, floats


def pointers(ego, actions, dt, step_count, tables, npc, outs) -> tuple:
    """The tensors of a call in csrc/ego_step.cuh's ``Args`` order, and the
    row stride of the NPC slots; checks what the kernel takes and raises on
    the rest. ``npc`` is ``(x, y, heading, alive)`` (B, w), or None; ``outs``
    the outputs."""
    B, n = ego.x.shape
    dev = ego.x.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    R = tables.paths.shape[0]
    want = [("route_id", ego.route_id, (B, n), i32)]
    want += [(k, getattr(ego, k), (B, n), f32) for k in ("x", "y", "v", "heading",
                                                         "steering_angle")]
    want += [("path_index", ego.path_index, (B, n), i32)]
    want += [(k, getattr(ego, k), (B, n), f32) for k in ("prev_dist_to_goal", "prev_acc_norm",
                                                         "prev_steer_norm")]
    want += [("alive", ego.alive, (B, n), b8), ("actions", actions, (B, n, 2), f32),
             ("dt", dt, tuple(dt.shape), f32), ("step_count", step_count, (B,), i32),
             ("paths", tables.paths, (R, PATH_LEN, 2), f32),
             ("goal_xy", tables.goal_xy, (R, 2), f32),
             ("goal_prev_xy", tables.goal_prev_xy, (R, 2), f32),
             ("spawn_xy", tables.spawn_xy, (R, 2), f32),
             ("spawn_heading", tables.spawn_heading, (R,), f32)]
    for name, t, shape, dtype in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ego_step: {name} must be {dtype} of shape {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ego_step: {name} must be contiguous")
    if dt.numel() != 1:
        raise ValueError(f"ego_step: dt must hold one value, got shape {tuple(dt.shape)}")
    slots, ld = [outs[0]] * 4, 0          # no slots: never read
    if npc is not None:
        w = npc[0].shape[1] if npc[0].dim() == 2 else -1
        ld = npc[0].stride(0)
        for name, t, dtype in zip(("npc x", "npc y", "npc heading", "npc alive"), npc,
                                  (f32, f32, f32, b8)):
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != (B, w):
                raise ValueError(f"ego_step: {name} must be {dtype} of shape (B, w) = "
                                 f"{(B, w)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
            if w > 1 and t.stride(1) != 1 or B > 1 and t.stride(0) != ld:
                raise ValueError(f"ego_step: {name} must have unit slot stride and the "
                                 f"others' row stride {ld}, got {t.stride()}")
        slots = list(npc)
    return [t for _, t, _, _ in want] + slots + list(outs), ld


def ego_step(ego, actions, dt, step_count, tables, npc, config, reward,
             max_progress: float) -> tuple:
    """ego_step_ref's arguments on the card -> ``(x, y, v, heading,
    steering_angle, prev_dist_to_goal, prev_acc_norm, prev_steer_norm,
    reward, path_index, status, done, agents_alive, step_count, terminated,
    truncated)``: the ego's new arrays and the step's per-agent results (B,
    N), then its per-env results (B,); new tensors.

    ego: the EgoState, (B, N) with 1 <= N <= 32; actions (B, N, 2) float32;
    dt: one float32; step_count (B,) int32, the counter the step increments;
    tables: the route table (``EgoTables``); npc: the NPC slots the egos
    collide with (``x``, ``y``, ``heading`` float32 and ``alive`` bool, (B,
    w)), or None without traffic."""
    dev = ego.x.device
    if dev.type != "cuda":
        raise ValueError(f"ego_step: a CUDA tensor is required, got {dev}")
    B, n = ego.x.shape
    if not 1 <= n <= MAX_AGENTS:
        raise ValueError(f"ego_step: 1 to {MAX_AGENTS} agents an env, got {n}")
    if npc is not None:
        npc = (npc.x, npc.y, npc.heading, npc.alive)
    w = 0 if npc is None else npc[0].shape[-1]
    f = torch.empty((9, B, n), dtype=torch.float32, device=dev)
    i = torch.empty((2, B, n), dtype=torch.int32, device=dev)
    done = torch.empty((B, n), dtype=torch.bool, device=dev)
    env_i = torch.empty((2, B), dtype=torch.int32, device=dev)
    env_b = torch.empty((2, B), dtype=torch.bool, device=dev)
    tensors, ld = pointers(ego, actions, dt, step_count, tables, npc, (f, i, done, env_i, env_b))
    lib = _lib()
    if lib.ego_step_envs_per_block(n, w) < 1:
        raise ValueError(f"ego_step: {w} NPC slots do not fit a block's shared memory")
    ints, floats = params(config, reward, max_progress, n, w, tables.paths.shape[0])
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    rc = lib.ego_step_launch(ptrs, ints.ctypes.data, floats.ctypes.data, B, ld,
                             native.stream_of(f))
    native.check(rc, lib, "ego_step")
    native.LAUNCHES["ego_step"] += 1
    return (*f[:9], i[0], i[1], done, env_i[0], env_i[1], env_b[0], env_b[1])
