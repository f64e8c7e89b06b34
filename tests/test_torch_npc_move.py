"""K2's per-planner body (csrc/npc_move.cuh), built for the CPU through
csrc/npc_move_host.cpp, against the plain version core/npc.py::move_ref,
bit for bit, every field of its result.

The header is the arithmetic the card runs; the card itself, with its warp
composition, is held against the plain version by tests/test_torch_cuda.py
and chip_smoke.py. Inputs (ops/npc_move_cases.py): tests/test_torch_npc.py's
seeded pools at widths 8, 16 and 32, with dead slots, chains of overlapping
cars and -0.0 headings, planned densely (S = M) and one slot per env chosen
by uid (S = 1); and the edge cases: a tie in the path-index window, a -0.0
heading, a car at the ghost scan's radius, cars near the scan window's first
and last points and just outside them.
"""
import ctypes

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core import npc
from marl_traffic_intersection_tpu_torch.core.constants import MAX_ACC, MAX_STEERING_ANGLE
from marl_traffic_intersection_tpu_torch.core.npc import move_ref
from marl_traffic_intersection_tpu_torch.core.physics import _PI, _TWO_PI
from marl_traffic_intersection_tpu_torch.ops import native
from marl_traffic_intersection_tpu_torch.ops.npc_move_cases import CASES, EDGE_ENVS, case_args
from marl_traffic_intersection_tpu_torch.ops.npc_move_cuda import npc_move

from ._torch_port import assert_bits


def _host() -> ctypes.CDLL:
    lib = native.load("npc_move_host.cpp")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.npc_move_host.argtypes = [p] * 17 + [i] * 3
        lib.npc_move_host.restype = i
        lib.npc_move_constants.argtypes = [p]
        lib.npc_move_constants.restype = i
        lib._typed = True
    return lib


def host_move(args) -> npc._Moved:
    """The header's move on move_ref's arguments (CPU tensors)."""
    sx, sy, sv, sh, ss, su, pi0, path, others, (x, y, v, heading, uid), dt = args
    B, S = sx.shape
    out = torch.empty((5, B, S), dtype=torch.float32)
    index = torch.empty((B, S), dtype=torch.int32)
    ins = [t.contiguous() for t in (sx, sy, sv, sh, ss, su, pi0, path, others, x, y, v,
                                    heading, uid, dt)]
    assert _host().npc_move_host(*map(native.ptr, ins + [out, index]), B, S,
                                 others.shape[-1]) == 0
    return npc._Moved(*out, index)


@pytest.mark.parametrize("kind,width", CASES)
def test_host_move_matches_the_plain_version(kind, width):
    args = case_args(kind, width)
    want, got = move_ref(*args), host_move(args)
    for name in npc._Moved._fields:
        assert_bits(name, getattr(want, name), getattr(got, name), f"{kind} w={width}")
    if kind == "edges":
        env = {name: i for i, name in enumerate(EDGE_ENVS)}
        # the tie: half-way between points 60 and 61, the lower index
        path = args[7]
        for i in (env["tie"], env["tie, -0.0 heading"]):
            d = [float((path[i, 0, k, 0] - got.x[i, 0]) ** 2) for k in (60, 61)]
            assert d[0] == d[1] and int(got.path_index[i, 0]) == 60
        assert torch.equal(args[3][env["tie, -0.0 heading"]].view(torch.int32),
                           torch.tensor([-2 ** 31], dtype=torch.int32))
        # a car near a scanned point brakes the planner, at 48 px or outside
        # the window it does not
        v = got.v[:, 0]
        assert v[env["car 47 px from a point"]] != v[env["car 48 px from a point"]]
        for name, brakes in (("car near the window's last point", True),
                             ("car near the point after the window", False),
                             ("car near the window's first point", True),
                             ("car near the point before the window", False)):
            assert bool(v[env[name]] != v[env[name] + 1]) == brakes, name
    else:
        # some plans brake hard (a ghost-scan conflict or a car ahead), others not
        th, _ = npc._plan(*args[:4], args[5], args[8], args[6], args[7], args[9])
        plans = set(th.flatten().tolist())
        assert -1.0 in plans and len(plans) > 1, sorted(plans)


def test_host_constants_are_the_plain_versions():
    out = np.empty(64, np.float32)
    n = _host().npc_move_constants(ctypes.c_void_p(out.ctypes.data))
    want = [_PI, _TWO_PI, npc._DEG30, npc._DEG45, npc._DEG60, npc._DEG150,
            npc._SAFE_RADIUS_SQ, npc._CX, npc._CY, npc._TARGET_SPEED, npc._TARGET_SPEED_HI,
            npc._SIDEWAYS, npc._NOT_FAR, npc._STABLE, npc._EPS, npc._DOT_MIN, npc._COAST,
            npc._EASE, npc._SOFT, npc._HARD, 1e9, MAX_ACC, MAX_STEERING_ANGLE, 0.2, 0.95, 8.0,
            54.0, 0.1, 160, 12, npc._SCAN_STEPS, 50]
    assert_bits("constants", np.asarray(want, np.float32), out[:n])


def test_move_takes_the_plain_version_on_the_cpu_and_the_kernel_refuses_it():
    args = case_args("slot", 8)
    native.reset_launches()
    got, want = npc._move(*args), move_ref(*args)
    for name in npc._Moved._fields:
        assert_bits(name, getattr(want, name), getattr(got, name))
    assert native.LAUNCHES["npc_move"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        npc_move(*args)
