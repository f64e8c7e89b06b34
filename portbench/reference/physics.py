"""Kinematic bicycle physics, OBB corners, SAT collision, path following.

On tensors of any batch shape, reproducing the reference's quirks (cpp/Car.cpp:9-141):
per-call steering lag with gain 0.2, the exact-zero-throttle 0.95 decay,
``dt`` only in the speed update, speed clamped to [0, 8], heading wrapped to
[-pi, pi), turning only when |v| > 0.1, and y-down screen coordinates.

Rounding follows the reference build: every product rounds before its add
(eager PyTorch runs each operator alone, so nothing contracts into an FMA),
trig goes
through the host glibc (libm.py), and ``v / WHEELBASE`` is an IEEE division.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import libm
from .constants import (CAR_LENGTH, CAR_WIDTH, MAX_ACC, MAX_STEERING_ANGLE,
                        PHYSICS_MAX_SPEED, PI_F, WHEELBASE)

_PI = float(np.float32(PI_F))
_TWO_PI = float(np.float32(2.0) * np.float32(PI_F))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi) with C ``fmod`` truncation semantics (Car.cpp:33-35)."""
    a = torch.fmod(a + _PI, _TWO_PI)
    a = torch.where(a < 0.0, a + _TWO_PI, a)
    return a - _PI


class CarPhysicsOut(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    v: torch.Tensor
    heading: torch.Tensor
    steering_angle: torch.Tensor
    acc: torch.Tensor


def car_physics_step(x, y, v, heading, steering_angle, throttle, steer,
                     dt: torch.Tensor) -> CarPhysicsOut:
    """One physics tick, matching Car::update (cpp/Car.cpp:9-40). All inputs
    are float32 tensors of one broadcast shape; ``dt`` a float32 tensor."""
    acc = throttle * MAX_ACC
    target_steering = steer * MAX_STEERING_ANGLE
    steering_angle = steering_angle + (target_steering - steering_angle) * 0.2
    v = torch.where(throttle == 0.0, v * 0.95, v)
    v = v + acc * dt
    v = torch.clamp(v, 0.0, PHYSICS_MAX_SPEED)
    ang_vel = libm.div(v, WHEELBASE) * libm.tanf(steering_angle)
    heading = torch.where(v.abs() > 0.1, heading + ang_vel, heading)
    heading = wrap_angle(heading)
    s, c = libm.sincosf(heading)
    x = x + v * c
    y = y - v * s
    return CarPhysicsOut(x, y, v, heading, steering_angle, acc)


# local corner offsets (lx, ly): (hl,hw), (hl,-hw), (-hl,-hw), (-hl,hw)
_CORNERS = np.asarray([[CAR_LENGTH * 0.5, CAR_LENGTH * 0.5, -CAR_LENGTH * 0.5, -CAR_LENGTH * 0.5],
                       [CAR_WIDTH * 0.5, -CAR_WIDTH * 0.5, -CAR_WIDTH * 0.5, CAR_WIDTH * 0.5]],
                      np.float32)


def car_corners(x, y, heading) -> torch.Tensor:
    """OBB corners, shape (..., 4, 2), in reference order (Car.cpp:86-103)."""
    lx, ly = libm.table(_CORNERS, x.device)
    s, c = (t[..., None] for t in libm.sincosf(heading))
    wx = x[..., None] + lx * c - ly * s
    wy = y[..., None] + lx * s + ly * c
    return torch.stack([wx, wy], dim=-1)


def sat_overlap(corners_a, heading_a, corners_b, heading_b) -> torch.Tensor:
    """Separating-axis OBB test over the two cars' body axes (Car.cpp:105-141).

    corners_*: (..., 4, 2); heading_*: (...,), broadcastable. Returns bool (...).
    """
    heading_a, heading_b = torch.broadcast_tensors(heading_a, heading_b)
    sa, ca = libm.sincosf(heading_a)
    sb, cb = libm.sincosf(heading_b)
    ax = torch.stack([ca, -sa, cb, -sb], dim=-1)   # (..., 4) axis x components
    ay = torch.stack([sa, ca, sb, cb], dim=-1)     # (..., 4) axis y components

    def proj(corners):   # (..., axes=4, corners=4)
        return (corners[..., None, :, 0] * ax[..., :, None]
                + corners[..., None, :, 1] * ay[..., :, None])

    pa = proj(corners_a)
    pb = proj(corners_b)
    min_a, max_a = pa.amin(-1), pa.amax(-1)
    min_b, max_b = pb.amin(-1), pb.amax(-1)
    separated = (max_a < min_b) | (max_b < min_a)
    return ~separated.any(-1)


def update_path_index(path, path_len: int, path_index, x, y,
                      search_range: int = 50) -> torch.Tensor:
    """Windowed nearest-point path index (Car.cpp:47-74): the first minimum of
    the squared distance over ``search_range`` points from the current index.

    path: (..., P, 2); path_index: (...) int; x, y: (...) float32.
    """
    path_index = path_index.clamp_min(0)
    iota = torch.arange(path.shape[-2], device=path.device, dtype=path_index.dtype)
    pi = path_index[..., None]
    in_window = (iota >= pi) & (iota < pi + search_range) & (iota < path_len)
    dx = path[..., 0] - x[..., None]
    dy = path[..., 1] - y[..., None]
    d = dx * dx + dy * dy
    d = torch.where(in_window, d, torch.inf)
    return torch.argmin(d, dim=-1).to(torch.int32)
