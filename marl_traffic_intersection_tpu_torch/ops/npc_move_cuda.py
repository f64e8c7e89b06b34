"""K2 wrapper: the NPC planner's move (csrc/npc_move.cu).

Replaces no TPU kernel (the JAX package plans its NPCs in XLA). On the card,
core/npc.py::_move calls ``npc_move`` for every set of planners: the exact
controller's dense plan and cleanup rounds, the fast and the serial
controllers. One launch plans, integrates and re-indexes every planner, in
place of move_ref's ~200 launches. The plain version, which the CPU runs and
the tests and chip_smoke.py hold the kernel to, is core/npc.py::move_ref.
The library is built with nvcc and loaded at first use, so a run without
NPC traffic never builds it; a CPU tensor, or anything else the kernel does
not take, raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.constants import PATH_LEN
from . import native

_SOURCE = "npc_move.cu"


def _lib() -> ctypes.CDLL:
    lib = native.load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.npc_move_launch.argtypes = [p] * 17 + [i, i, i, p]
        lib.npc_move_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def npc_move(sx, sy, sv, sh, ss, su, pi0, path, others, pool, dt) -> tuple:
    """move_ref's arguments on the card -> ``(x, y, v, heading,
    steering_angle, path_index)``, each (B, S): float32 but the int32 index.

    sx, sy, sv, sh, ss (B, S) float32 and su, pi0 (B, S) int32: the planners'
    pose, speed, heading, steering angle, uid and refreshed path index; path
    (B, S, 160, 2) float32: their polylines; others (B, S, M) bool: the slots
    each looks at; pool = (x, y, v, heading, uid), (B, M) float32 but uid
    int32: the slots' poses; dt: one float32. The outputs are new tensors,
    so the planners may read the poses they replace."""
    dev = sx.device
    if dev.type != "cuda":
        raise ValueError(f"npc_move: a CUDA tensor is required, got {dev}")
    B, S = sx.shape
    M = others.shape[-1]
    x, y, v, heading, uid = pool
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dtype in (("sx", sx, (B, S), f32), ("sy", sy, (B, S), f32),
                                  ("sv", sv, (B, S), f32), ("sh", sh, (B, S), f32),
                                  ("ss", ss, (B, S), f32), ("su", su, (B, S), i32),
                                  ("pi0", pi0, (B, S), i32),
                                  ("path", path, (B, S, PATH_LEN, 2), f32),
                                  ("others", others, (B, S, M), torch.bool),
                                  ("x", x, (B, M), f32), ("y", y, (B, M), f32),
                                  ("v", v, (B, M), f32), ("heading", heading, (B, M), f32),
                                  ("uid", uid, (B, M), i32), ("dt", dt, tuple(dt.shape), f32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"npc_move: {name} must be {dtype} of shape {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"npc_move: {name} must be contiguous")
    if dt.numel() != 1:
        raise ValueError(f"npc_move: dt must hold one value, got shape {tuple(dt.shape)}")
    if path.data_ptr() % 8:
        raise ValueError("npc_move: path must be 8-byte aligned")
    lib = _lib()
    out = torch.empty((5, B, S), dtype=f32, device=dev)
    index = torch.empty((B, S), dtype=i32, device=dev)
    rc = lib.npc_move_launch(*map(native.ptr, (sx, sy, sv, sh, ss, su, pi0, path, others, x, y,
                                               v, heading, uid, dt, out, index)),
                             B, S, M, native.stream_of(out))
    native.check(rc, lib, "npc_move")
    native.LAUNCHES["npc_move"] += 1
    return (*out, index)
