"""Beam lidar ray march in plain PyTorch over an explicit batch.

Each of 96 rays marches 63 samples 4 px apart from the car centre and stops
at the first event (reference: cpp/Lidar.cpp:22-90):

  1. sample off the screen           -> stop, no hit;
  2. dist > 0 and off the road        -> hit;
  3. dist > 0 and inside the AABB of an obstacle whose pose is not within
     1e-3 of the scanning car's own  -> hit.

Sample coordinates are ``int()``-truncated before every test, each product
rounds before its add, the ray directions come from the host glibc (libm.py), and the
screen test is the reference's four compares (``x < 0 || x >= W || y < 0 ||
y >= H``). This version evaluates the whole (rays x samples) grid and takes
the first event with an argmax, and can return the samples each ray
marches, which the benchmark's roofline counts as the work of a march.
"""
from __future__ import annotations

import numpy as np
import torch

from . import libm
from .constants import (CAR_LENGTH, CAR_WIDTH, HEIGHT, LIDAR_FOV_DEG,
                        LIDAR_MAX_DIST, LIDAR_RAYS, LIDAR_SAMPLES, LIDAR_STEP,
                        WIDTH)
from .geometry import off_road_grid_fast


def ray_rel_angles(rays: int = LIDAR_RAYS, fov_deg: float = LIDAR_FOV_DEG) -> np.ndarray:
    """Relative ray angles in radians with the reference's f32 op chain
    (cpp/Lidar.cpp:5-14): ``deg = start + i*step``, then ``deg * PI_F / 180``."""
    f = np.float32
    start = f(-f(fov_deg) * f(0.5))
    step = f(f(fov_deg) / f(float(rays - 1))) if rays > 1 else f(0.0)
    pi_f = f(3.14159265358979323846)
    deg = start + np.arange(rays, dtype=np.float32) * step
    return (deg * pi_f / f(180.0)).astype(np.float32)


REL_ANGLES = ray_rel_angles()
DISTS = np.arange(LIDAR_SAMPLES, dtype=np.float32) * np.float32(LIDAR_STEP)


def obstacle_boxes(sx, sy, sh, ox, oy, oh, om):
    """Per-(agent, obstacle) AABBs (B, N, M) for the obstacles each agent
    sees: present (``om``) and not within 1e-3 of the agent's own pose (the
    reference's self/duplicate exclusion, Lidar.cpp:55-63). Boxes of the
    others are inverted (+inf lower, -inf upper bounds), so they never hit."""
    eps = 1e-3
    same = (((ox[:, None, :] - sx[:, :, None]).abs() < eps)
            & ((oy[:, None, :] - sy[:, :, None]).abs() < eps)
            & ((oh[:, None, :] - sh[:, :, None]).abs() < eps))
    active = om[:, None, :] & ~same
    hl, hw = CAR_LENGTH * 0.5, CAR_WIDTH * 0.5     # 27 and 12, exact in f32
    s, c = (t.abs() for t in libm.sincosf(oh))
    ex = c * hl + s * hw
    ey = s * hl + c * hw
    inf = torch.inf
    lox = torch.where(active, (ox - ex)[:, None, :], inf)
    hix = torch.where(active, (ox + ex)[:, None, :], -inf)
    loy = torch.where(active, (oy - ey)[:, None, :], inf)
    hiy = torch.where(active, (oy + ey)[:, None, :], -inf)
    return lox, hix, loy, hiy


def lidar_scan_ref(sx, sy, sh, ox, oy, oh, om, num_lanes: int = 3,
                   return_samples: bool = False):
    """Batched dense march.

    sx, sy, sh: (B, N) float32 scanner poses; ox, oy, oh: (B, M) float32 and
    om: (B, M) bool obstacle poses and presence. Returns (B, N, 96) float32
    distances (4*k for a hit at sample k, 250 with no hit) and, with
    ``return_samples``, the (B, N, 96) int32 count of samples the reference
    marches on each ray (up to and including the first event; 63 without
    one), the work measure of a march.
    """
    dev = sx.device
    rel = libm.table(REL_ANGLES, dev)
    dists = libm.table(DISTS, dev)
    samples_max = dists.shape[0]
    ang = sh[..., None] + rel                                   # (B, N, R)
    s, dx = libm.sincosf(ang)
    dy = -s
    px = torch.trunc(sx[..., None, None] + dx[..., None] * dists)   # (B, N, R, S)
    py = torch.trunc(sy[..., None, None] + dy[..., None] * dists)
    oob = (px < 0.0) | (px >= float(WIDTH)) | (py < 0.0) | (py >= float(HEIGHT))

    hit = off_road_grid_fast(px, py, num_lanes)
    lox, hix, loy, hiy = obstacle_boxes(sx, sy, sh, ox, oy, oh, om)
    for m in range(ox.shape[1]):
        lo_x = lox[..., m, None, None]
        hi_x = hix[..., m, None, None]
        lo_y = loy[..., m, None, None]
        hi_y = hiy[..., m, None, None]
        hit |= (px >= lo_x) & (px <= hi_x) & (py >= lo_y) & (py <= hi_y)
    hit &= (dists > 0.0) & ~oob      # off the screen comes first and is no hit

    event = oob | hit
    any_event = event.any(-1)
    first = torch.where(any_event, event.to(torch.uint8).argmax(-1),
                        samples_max)                            # (B, N, R)
    first_is_hit = hit.gather(-1, first.clamp_max(samples_max - 1)[..., None])[..., 0]
    is_hit = any_event & first_is_hit
    out = torch.where(is_hit, first.to(torch.float32) * float(np.float32(LIDAR_STEP)),
                      float(np.float32(LIDAR_MAX_DIST)))
    if return_samples:
        samples = torch.where(any_event, first + 1, samples_max).to(torch.int32)
        return out, samples
    return out
