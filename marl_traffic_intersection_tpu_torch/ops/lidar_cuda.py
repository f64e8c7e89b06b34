"""K1 wrapper: the batched lidar ray march (csrc/lidar.cu).

Replaces the TPU kernel marl_traffic_intersection_tpu/ops/lidar_pallas.py
(``lidar_scan_pallas``). A CPU tensor takes the plain version
(core/lidar.py::lidar_scan_ref); a CUDA tensor launches the kernel, built
with nvcc at first use, or raises. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.constants import LIDAR_RAYS
from ..core.lidar import REL_ANGLES, lidar_scan_ref
from . import libm, native

_SOURCE = "lidar.cu"


def _lib() -> ctypes.CDLL:
    lib = native.load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lidar_scan_launch.argtypes = [p] * 9 + [i, i, i, i, p]
        lib.lidar_scan_launch.restype = ctypes.c_int
        lib.lidar_max_obstacles.argtypes, lib.lidar_max_obstacles.restype = [], ctypes.c_int
        lib.lidar_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
        lib.lidar_blocks_per_sm.restype = ctypes.c_int
        lib._typed = True
    return lib


def lidar_scan(sx, sy, sh, ox, oy, oh, om, num_lanes: int = 3) -> torch.Tensor:
    """sx, sy, sh (B, N) float32; ox, oy, oh (B, M) float32; om (B, M) bool
    -> (B, N, 96) float32 distances."""
    if sx.device.type == "cpu":
        return lidar_scan_ref(sx, sy, sh, ox, oy, oh, om, num_lanes)
    if sx.device.type != "cuda":
        raise ValueError(f"lidar_scan: unsupported device {sx.device}")
    B, N = sx.shape
    M = ox.shape[1] if ox.dim() == 2 else -1
    for name, t, shape, dtype in (("sx", sx, (B, N), torch.float32),
                                  ("sy", sy, (B, N), torch.float32),
                                  ("sh", sh, (B, N), torch.float32),
                                  ("ox", ox, (B, M), torch.float32),
                                  ("oy", oy, (B, M), torch.float32),
                                  ("oh", oh, (B, M), torch.float32),
                                  ("om", om, (B, M), torch.bool)):
        if t.device != sx.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"lidar_scan: {name} must be {dtype} of shape {shape} on "
                             f"{sx.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"lidar_scan: {name} must be contiguous")
    lib = _lib()
    if M > lib.lidar_max_obstacles():
        raise ValueError(f"lidar_scan: at most {lib.lidar_max_obstacles()} obstacles, got {M}")
    out = torch.empty((B, N, LIDAR_RAYS), dtype=torch.float32, device=sx.device)
    rel = libm.table(REL_ANGLES, sx.device)
    rc = lib.lidar_scan_launch(*map(native.ptr, (sx, sy, sh, ox, oy, oh, om, rel, out)),
                               B, N, M, int(num_lanes), native.stream_of(out))
    native.check(rc, lib, "lidar_scan")
    native.LAUNCHES["lidar_scan"] += 1
    return out


def blocks_per_sm(num_obstacles: int) -> int:
    """How many of the kernel's blocks one SM holds at once with
    ``num_obstacles`` obstacles (needs the card)."""
    lib = _lib()
    blocks = ctypes.c_int()
    native.check(lib.lidar_blocks_per_sm(num_obstacles, ctypes.byref(blocks)), lib,
                 "lidar_blocks_per_sm")
    return blocks.value
