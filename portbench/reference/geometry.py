"""Analytic road geometry and line-mask tests on tensors of any shape.

The analytic road shape of the reference simulator (RoadGeometry.h:19-67)
and its pixel-exact yellow-line mask (LineMask.cpp:47-72), as elementwise
torch functions. Every square is rounded before its sum, as in the
reference build (no FMA).
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import CORNER_RADIUS, HEIGHT, LANE_WIDTH_PX, WIDTH

_CX = float(np.float32(WIDTH * 0.5))
_CY = float(np.float32(HEIGHT * 0.5))


def is_on_road(x: torch.Tensor, y: torch.Tensor, num_lanes: int = 3) -> torch.Tensor:
    """Analytic on-road test (reference: cpp/RoadGeometry.h:19-58): the
    vertical and horizontal strips and four corner squares, minus four grass
    circles."""
    rw = float(np.float32(num_lanes * LANE_WIDTH_PX))
    cr = float(np.float32(CORNER_RADIUS))
    r2 = cr * cr
    in_grass = torch.zeros_like(x, dtype=torch.bool)
    for gx, gy in ((_CX - rw - cr, _CY - rw - cr), (_CX + rw + cr, _CY - rw - cr),
                   (_CX - rw - cr, _CY + rw + cr), (_CX + rw + cr, _CY + rw + cr)):
        dx = x - gx
        dy = y - gy
        in_grass |= dx * dx + dy * dy <= r2
    in_vertical = (x >= _CX - rw) & (x <= _CX + rw)
    in_horizontal = (y >= _CY - rw) & (y <= _CY + rw)
    in_x_band = ((x >= _CX - rw - cr) & (x <= _CX - rw)) | ((x >= _CX + rw) & (x <= _CX + rw + cr))
    in_y_band = ((y >= _CY - rw - cr) & (y <= _CY - rw)) | ((y >= _CY + rw) & (y <= _CY + rw + cr))
    return ~in_grass & (in_vertical | in_horizontal | (in_x_band & in_y_band))


def off_road_grid_fast(x: torch.Tensor, y: torch.Tensor, num_lanes: int = 3) -> torch.Tensor:
    """``~is_on_road`` for integer-valued float coords (the lidar samples).

    Every quantity is an integer below 2**24, so the f32 arithmetic is exact
    and the four grass circles fold into one test against the nearest
    centre. The strip test is written as compares (not a min/max fold), as in
    the reference and in the CUDA kernel (csrc/lidar.cu).
    """
    rw = float(np.float32(num_lanes * LANE_WIDTH_PX))
    cr = float(np.float32(CORNER_RADIUS))
    d = rw + cr
    ax = (x - _CX).abs()
    ay = (y - _CY).abs()
    gx = ax - d
    gy = ay - d
    in_grass = gx * gx + gy * gy <= cr * cr
    on_rect = (ax <= rw) | (ay <= rw) | ((ax <= d) & (ay <= d))
    return in_grass | ~on_rect


def hits_yellow_line(x: torch.Tensor, y: torch.Tensor, num_lanes: int = 3) -> torch.Tensor:
    """Analytic centre-line test (reference: cpp/RoadGeometry.h:60-67)."""
    rw = float(np.float32(num_lanes * LANE_WIDTH_PX))
    v = ((x - _CX).abs() <= 2.0) & ((y - _CY).abs() > rw)
    h = ((y - _CY).abs() <= 2.0) & ((x - _CX).abs() > rw)
    return v | h


def is_line_pixel(xi: torch.Tensor, yi: torch.Tensor, num_lanes: int = 3) -> torch.Tensor:
    """Pixel-exact yellow-line mask on integer coords (LineMask.h:15-18):
    thickness-2 segments at cx±2 / cy±2, stopping ``rw + cr`` from the
    centre; out-of-bounds queries are False. Callers truncate toward zero."""
    cx, cy = WIDTH // 2, HEIGHT // 2
    stop = int(num_lanes * int(LANE_WIDTH_PX)) + int(CORNER_RADIUS)
    in_bounds = (xi >= 0) & (xi < WIDTH) & (yi >= 0) & (yi < HEIGHT)
    vband = ((xi >= cx - 3) & (xi <= cx - 1)) | ((xi >= cx + 1) & (xi <= cx + 3))
    vspan = (yi <= cy - stop) | (yi >= cy + stop)
    hband = ((yi >= cy - 3) & (yi <= cy - 1)) | ((yi >= cy + 1) & (yi <= cy + 3))
    hspan = (xi <= cx - stop) | (xi >= cx + stop)
    return in_bounds & ((vband & vspan) | (hband & hspan))
