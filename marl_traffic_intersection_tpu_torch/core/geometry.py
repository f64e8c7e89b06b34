"""Analytic road geometry and line-mask tests on tensors of any shape.

Counterpart of marl_traffic_intersection_tpu/core/geometry.py: the analytic
road shape of the reference (RoadGeometry.h:19-67) and the pixel-exact
yellow-line mask (LineMask.cpp:47-72), as elementwise torch functions. Every
square is rounded before its sum, as in the reference build (no FMA).

The reference's pixel RoadMask (``road_obstacle_mask``, ``is_obstacle_pixel``)
and the rasterized LineMask grid (``rasterize_line_mask``) are host helpers
kept for parity and debug pictures: the reference never calls
``RoadMask::is_obstacle`` (SURVEY.md section 2, #5), and the analytic
``is_on_road`` drives the lidar and the collisions here as there.
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


def _mask_extent(num_lanes: int):
    """The RoadMask's centre, road half-width and corner square, in pixels."""
    rw, cr = int(round(num_lanes * LANE_WIDTH_PX)), int(round(CORNER_RADIUS))
    return WIDTH // 2, HEIGHT // 2, rw, cr


def road_obstacle_mask(num_lanes: int = 3) -> np.ndarray:
    """The reference RoadMask's pixel grid (RoadMask.cpp:43-71), 1 =
    obstacle (grass), 0 = road: the road cross and the four corner squares
    cut out of a full grid, the corner grass circles not put back (the
    reference's comment at RoadMask.cpp:64-70)."""
    grid = np.ones((HEIGHT, WIDTH), dtype=np.uint8)
    cx, cy, rw, cr = _mask_extent(num_lanes)
    grid[:, cx - rw:cx + rw] = 0
    grid[cy - rw:cy + rw, :] = 0
    for x0, y0 in ((cx - rw - cr, cy - rw - cr), (cx + rw, cy - rw - cr),
                   (cx - rw - cr, cy + rw), (cx + rw, cy + rw)):
        grid[max(0, y0):y0 + cr, max(0, x0):x0 + cr] = 0
    return grid


def is_obstacle_pixel(xi: torch.Tensor, yi: torch.Tensor, num_lanes: int = 3) -> torch.Tensor:
    """``RoadMask::is_obstacle`` (RoadMask.h:15-18) on integer coords: False
    out of bounds (a ray stops there, it does not hit), else the complement
    of the road cross and the corner squares of ``road_obstacle_mask``."""
    cx, cy, rw, cr = _mask_extent(num_lanes)
    in_bounds = (xi >= 0) & (xi < WIDTH) & (yi >= 0) & (yi < HEIGHT)
    in_cross = ((xi >= cx - rw) & (xi < cx + rw)) | ((yi >= cy - rw) & (yi < cy + rw))
    in_x = ((xi >= cx - rw - cr) & (xi < cx - rw)) | ((xi >= cx + rw) & (xi < cx + rw + cr))
    in_y = ((yi >= cy - rw - cr) & (yi < cy - rw)) | ((yi >= cy + rw) & (yi < cy + rw + cr))
    return in_bounds & ~(in_cross | (in_x & in_y))


def rasterize_line_mask(num_lanes: int = 3) -> np.ndarray:
    """The reference LineMask grid drawn pixel by pixel (LineMask.cpp:14-72),
    1 = yellow line: thickness-2 segments (one pixel either side) at cx±2
    and cy±2, from the screen's edges to ``rw + cr`` from the centre."""
    grid = np.zeros((HEIGHT, WIDTH), dtype=np.uint8)
    cx, cy = WIDTH // 2, HEIGHT // 2
    stop = int(num_lanes * int(LANE_WIDTH_PX)) + int(CORNER_RADIUS)

    def span(a, b, n):                   # the segment's pixels on an axis of n
        return slice(max(0, min(a, b)), min(n, max(a, b) + 1))

    for c in (cx - 2, cx + 2):
        for ends in ((0, cy - stop), (HEIGHT, cy + stop)):
            grid[span(*ends, HEIGHT), max(0, c - 1):c + 2] = 1
    for c in (cy - 2, cy + 2):
        for ends in ((0, cx - stop), (WIDTH, cx + stop)):
            grid[max(0, c - 1):c + 2, span(*ends, WIDTH)] = 1
    return grid
