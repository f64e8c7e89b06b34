"""Lane layout and route/path generation (host numpy).

The table is built on the host once and moved to
the device by the env. Instead of generating a per-car ``std::vector`` polyline at
spawn time (reference: cpp/RouteGen.cpp:111-205), we precompute a constant
``(num_routes, PATH_LEN, 2)`` float32 path table for *all* IN->OUT pairs at
environment-construction time on the host. On device, a car's route is just an
int32 index into this table; path following becomes a gather + windowed argmin.

Semantics mirrored from the reference:
  - lane layout points:      cpp/RouteGen.cpp:7-53 (750x750 canvas, MARGIN=30)
  - intent classification:   cpp/RouteGen.cpp:55-87
  - path generation:         cpp/RouteGen.cpp:111-205
    (linear approach -> straight segment | quadratic Bezier through center |
     corner arc -> linear exit; 50 + 60 + 50 = 160 points)
  - NPC route fallback list: cpp/TrafficFlow.cpp:198-238 (straight + left per
    in-lane)
  - default ego route maps:  utils.py:29-52

Note: the reference's Python ``utils.build_lane_layout`` uses a 900x900 canvas
(utils.py:4) that disagrees with the authoritative 750x750 C++ layout; only the
C++ layout drives the simulation, so this module implements the 750x750 one.
All arithmetic is performed in float32 with the reference's operation order;
the arc trig (cpp/RouteGen.cpp:183-195 calls ``std::cos/std::sin`` on float,
i.e. libm cosf/sinf) and the spawn heading's atan2 go through the HOST libm
through libm.py, so the whole table is bit-identical to the
compiled C++ pipeline — including right-turn corner arcs, where an
f64-rounded numpy cosine disagrees with cosf on 1-ulp cases.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .libm import glibc_np
from .constants import (
    CORNER_RADIUS,
    HEIGHT,
    LANE_WIDTH_PX,
    PATH_LEN,
    WIDTH,
)

INTENT_STRAIGHT = 0
INTENT_LEFT = 1
INTENT_RIGHT = 2

_DIR_ORDER = ("N", "E", "S", "W")
_OPPOSITE = {"N": "S", "S": "N", "E": "W", "W": "E"}
_LEFT_TURN = {"N": "E", "E": "S", "S": "W", "W": "N"}
_RIGHT_TURN = {"N": "W", "W": "S", "S": "E", "E": "N"}

# Default ego route mappings (reference: utils.py:29-52)
DEFAULT_ROUTE_MAPPING_2LANES: Dict[str, List[str]] = {
    "IN_1": ["OUT_3"],
    "IN_2": ["OUT_6"],
    "IN_3": ["OUT_5"],
    "IN_4": ["OUT_8"],
    "IN_6": ["OUT_2"],
    "IN_7": ["OUT_1"],
    "IN_8": ["OUT_4"],
}

DEFAULT_ROUTE_MAPPING_3LANES: Dict[str, List[str]] = {
    "IN_1": ["OUT_4"],
    "IN_2": ["OUT_8"],
    "IN_3": ["OUT_12"],
    "IN_4": ["OUT_7"],
    "IN_5": ["OUT_11"],
    "IN_6": ["OUT_3"],
    "IN_7": ["OUT_10"],
    "IN_8": ["OUT_2"],
    "IN_9": ["OUT_6"],
    "IN_10": ["OUT_1"],
    "IN_11": ["OUT_5"],
    "IN_12": ["OUT_9"],
}


def build_lane_layout(num_lanes: int) -> dict:
    """Build the IN_k/OUT_k spawn-point layout (reference: cpp/RouteGen.cpp:7-53).

    Returns a dict with 'points' (name -> (x, y)), 'in_by_dir', 'out_by_dir',
    'dir_of', 'idx_of', 'dir_order' — the same structure the reference exposes.
    """
    cx, cy = WIDTH * 0.5, HEIGHT * 0.5
    margin = 30.0

    points: Dict[str, Tuple[float, float]] = {}
    in_by_dir = {d: [] for d in _DIR_ORDER}
    out_by_dir = {d: [] for d in _DIR_ORDER}
    dir_of: Dict[str, str] = {}
    idx_of: Dict[str, int] = {}

    for d_idx, d in enumerate(_DIR_ORDER):
        for j in range(num_lanes):
            offset = LANE_WIDTH_PX * (0.5 + j)
            in_name = f"IN_{d_idx * num_lanes + j + 1}"
            out_name = f"OUT_{d_idx * num_lanes + j + 1}"
            if d == "N":
                pin = (cx - offset, margin)
                pout = (cx + offset, margin)
            elif d == "S":
                pin = (cx + offset, HEIGHT - margin)
                pout = (cx - offset, HEIGHT - margin)
            elif d == "E":
                pin = (WIDTH - margin, cy - offset)
                pout = (WIDTH - margin, cy + offset)
            else:  # W
                pin = (margin, cy + offset)
                pout = (margin, cy - offset)
            points[in_name] = pin
            points[out_name] = pout
            dir_of[in_name] = d
            dir_of[out_name] = d
            idx_of[in_name] = j
            idx_of[out_name] = j
            in_by_dir[d].append(in_name)
            out_by_dir[d].append(out_name)

    return {
        "points": points,
        "in_by_dir": in_by_dir,
        "out_by_dir": out_by_dir,
        "dir_of": dir_of,
        "idx_of": idx_of,
        "dir_order": list(_DIR_ORDER),
    }


def determine_intent(layout: dict, start_id: str, end_id: str) -> int:
    """Classify a route as straight/left/right (reference: cpp/RouteGen.cpp:55-87)."""
    dir_of = layout["dir_of"]
    if start_id not in dir_of or end_id not in dir_of:
        return INTENT_LEFT
    s, e = dir_of[start_id], dir_of[end_id]
    if e == _OPPOSITE[s]:
        return INTENT_STRAIGHT
    if e == _LEFT_TURN[s]:
        return INTENT_LEFT
    if e == _RIGHT_TURN[s]:
        return INTENT_RIGHT
    return INTENT_LEFT


def _project_to_box(pt: Tuple[float, float], num_lanes: int) -> Tuple[float, float]:
    """Project a spawn point onto the intersection box (reference: cpp/RouteGen.cpp:89-101)."""
    cx, cy = WIDTH * 0.5, HEIGHT * 0.5
    tb = num_lanes * LANE_WIDTH_PX
    x, y = pt
    if y < cy - tb:
        return (x, cy - tb)
    if y > cy + tb:
        return (x, cy + tb)
    if x < cx - tb:
        return (cx - tb, y)
    return (cx + tb, y)


from .constants import PI_F as _PI_F64
_PI_F32 = np.float32(_PI_F64)  # f32-rounded pi, as the C++ PI_F literal


def _cos32(theta32: np.ndarray) -> np.ndarray:
    """Host-libm ``cosf`` — bit-identical to the reference's ``std::cos(float)``
    (cpp/RouteGen.cpp:183-195). An f64 cosine rounded to f32 differs on 1-ulp
    cases (e.g. the IN_3->OUT_12 arc), so the real libm is called via ctypes."""
    return glibc_np("cosf", theta32)


def _sin32(theta32: np.ndarray) -> np.ndarray:
    """Host-libm ``sinf`` (see ``_cos32``)."""
    return glibc_np("sinf", theta32)


def generate_path(layout: dict, num_lanes: int, intent: int, start_id: str, end_id: str) -> np.ndarray:
    """Generate the 160-point route polyline (reference: cpp/RouteGen.cpp:111-205).

    Returns float32 array of shape (PATH_LEN, 2). All arithmetic is performed
    in float32 with the reference's operation order, and arc trig calls the
    host libm's cosf/sinf (the functions ``std::cos/std::sin(float)`` resolve
    to), so every segment — linear, Bezier, and right-turn corner arc — is
    bit-identical to the C++ float pipeline.
    """
    f = np.float32
    cx, cy = f(WIDTH * 0.5), f(HEIGHT * 0.5)
    p_start = np.asarray(layout["points"][start_id], dtype=f)
    p_end = np.asarray(layout["points"][end_id], dtype=f)
    entry_p = np.asarray(_project_to_box(tuple(p_start), num_lanes), dtype=f)
    exit_p = np.asarray(_project_to_box(tuple(p_end), num_lanes), dtype=f)

    def lerp50(a, b):
        t = (np.arange(50, dtype=f) / f(50.0))[:, None]
        return a[None, :] + (b - a)[None, :] * t

    pts: List[np.ndarray] = []

    if intent in (INTENT_STRAIGHT, INTENT_LEFT):
        pts.append(lerp50(p_start, entry_p))
        t = (np.arange(60, dtype=f) / f(60.0))[:, None]
        if intent == INTENT_STRAIGHT:
            pts.append(entry_p[None, :] + (exit_p - entry_p)[None, :] * t)
        else:
            ctrl = np.array([cx, cy], dtype=f)
            omt = f(1.0) - t
            # Reference op order: (1-t)*(1-t)*p0 + 2*(1-t)*t*p1 + t*t*p2
            pts.append(omt * omt * entry_p[None, :]
                       + f(2.0) * omt * t * ctrl[None, :]
                       + t * t * exit_p[None, :])
        pts.append(lerp50(exit_p, p_end))
        path = np.concatenate(pts, axis=0)
        assert path.shape == (PATH_LEN, 2)
        return path

    # Right-turn corner arc (reference: cpp/RouteGen.cpp:146-204)
    start_dir = layout["dir_of"].get(start_id, "N")
    rhw = f(num_lanes) * f(LANE_WIDTH_PX)
    half_pi = _PI_F32 / f(2.0)
    if start_dir == "N":
        cc = np.array([cx - rhw - f(CORNER_RADIUS), cy - rhw - f(CORNER_RADIUS)], f)
        th0, th1 = f(0.0), half_pi
    elif start_dir == "E":
        cc = np.array([cx + rhw + f(CORNER_RADIUS), cy - rhw - f(CORNER_RADIUS)], f)
        th0, th1 = half_pi, _PI_F32
    elif start_dir == "S":
        cc = np.array([cx + rhw + f(CORNER_RADIUS), cy + rhw + f(CORNER_RADIUS)], f)
        th0, th1 = _PI_F32, f(3.0) * _PI_F32 / f(2.0)
    else:  # W
        cc = np.array([cx - rhw - f(CORNER_RADIUS), cy + rhw + f(CORNER_RADIUS)], f)
        th0, th1 = -half_pi, f(0.0)

    r = f(CORNER_RADIUS) + f(0.5) * f(LANE_WIDTH_PX)
    arc_start = np.array([cc[0] + r * _cos32(th0), cc[1] + r * _sin32(th0)], f)
    arc_end = np.array([cc[0] + r * _cos32(th1), cc[1] + r * _sin32(th1)], f)

    pts.append(lerp50(p_start, arc_start))
    t = np.arange(60, dtype=f) / f(60.0)
    theta = th0 + (th1 - th0) * t
    pts.append(np.stack([cc[0] + r * _cos32(theta), cc[1] + r * _sin32(theta)], axis=1))
    pts.append(lerp50(arc_end, p_end))

    path = np.concatenate(pts, axis=0)
    assert path.shape == (PATH_LEN, 2)
    return path


@dataclass(frozen=True)
class RouteTable:
    """Precomputed constant route data for all IN->OUT pairs of a layout.

    Route id convention: ``route_id = in_global * (4 * num_lanes) + out_global``
    where ``in_global``/``out_global`` are 0-based indices of IN_{k+1}/OUT_{k+1}.
    All arrays are host numpy; the env closes over them as jit constants.
    """

    num_lanes: int
    paths: np.ndarray          # (R, PATH_LEN, 2) f32
    spawn_xy: np.ndarray       # (R, 2) f32 — IN point
    spawn_heading: np.ndarray  # (R,) f32 — atan2(-dy, dx) of first path segment
    intent: np.ndarray         # (R,) i32
    goal_xy: np.ndarray        # (R, 2) f32 — path[-1]
    goal_prev_xy: np.ndarray   # (R, 2) f32 — path[-2] (success-axis test)
    traffic_route_ids: np.ndarray  # (T,) i32 — NPC spawn route list
    layout: dict = field(repr=False)

    @property
    def num_points(self) -> int:
        return 4 * self.num_lanes

    def route_id(self, start_id: str, end_id: str) -> int:
        n = self.num_points
        si = int(start_id.split("_")[1]) - 1
        ei = int(end_id.split("_")[1]) - 1
        assert 0 <= si < n and 0 <= ei < n, (start_id, end_id)
        return si * n + ei

    def route_name(self, route_id: int) -> Tuple[str, str]:
        n = self.num_points
        return (f"IN_{route_id // n + 1}", f"OUT_{route_id % n + 1}")

    def route_ids(self, routes: Sequence[Tuple[str, str]]) -> np.ndarray:
        return np.asarray([self.route_id(s, e) for s, e in routes], dtype=np.int32)


def default_ego_routes(num_agents: int, num_lanes: int) -> List[Tuple[str, str]]:
    """Default ego route assignment (reference: env.py:138-146)."""
    mapping = DEFAULT_ROUTE_MAPPING_2LANES if num_lanes == 2 else DEFAULT_ROUTE_MAPPING_3LANES
    all_routes = [(s, e) for s, ends in mapping.items() for e in ends]
    return [all_routes[i % len(all_routes)] for i in range(num_agents)]


def default_traffic_routes(layout: dict) -> List[Tuple[str, str]]:
    """NPC spawn route list: straight + left per in-lane (reference: cpp/TrafficFlow.cpp:198-238)."""
    routes: List[Tuple[str, str]] = []
    for d in layout["dir_order"]:
        in_lanes = layout["in_by_dir"][d]
        straight_out = layout["out_by_dir"][_OPPOSITE[d]]
        left_out = layout["out_by_dir"][_LEFT_TURN[d]]
        for start_id in in_lanes:
            idx = max(0, layout["idx_of"].get(start_id, 0))
            if straight_out:
                routes.append((start_id, straight_out[min(idx, len(straight_out) - 1)]))
            if left_out:
                routes.append((start_id, left_out[min(idx, len(left_out) - 1)]))
    return routes


def build_route_table(num_lanes: int = 3) -> RouteTable:
    """Precompute paths/spawn/goal data for every IN->OUT pair."""
    layout = build_lane_layout(num_lanes)
    n = 4 * num_lanes
    nroutes = n * n

    paths = np.zeros((nroutes, PATH_LEN, 2), dtype=np.float32)
    spawn_xy = np.zeros((nroutes, 2), dtype=np.float32)
    spawn_heading = np.zeros((nroutes,), dtype=np.float32)
    intent = np.zeros((nroutes,), dtype=np.int32)

    for si in range(n):
        for ei in range(n):
            start_id, end_id = f"IN_{si + 1}", f"OUT_{ei + 1}"
            rid = si * n + ei
            it = determine_intent(layout, start_id, end_id)
            p = generate_path(layout, num_lanes, it, start_id, end_id)
            paths[rid] = p
            spawn_xy[rid] = np.asarray(layout["points"][start_id], dtype=np.float32)
            # Heading from first path segment (reference: cpp/IntersectionEnv.cpp:88-92,
            # `std::atan2(-dy, dx)` on float = libm atan2f) — host-libm call for
            # bit-identity with the compiled reference.
            dx = np.float32(p[1, 0]) - np.float32(p[0, 0])
            dy = np.float32(p[1, 1]) - np.float32(p[0, 1])
            spawn_heading[rid] = glibc_np("atan2f", -dy, dx)
            intent[rid] = it

    table = RouteTable(
        num_lanes=num_lanes,
        paths=paths,
        spawn_xy=spawn_xy,
        spawn_heading=spawn_heading,
        intent=intent,
        goal_xy=paths[:, -1, :].copy(),
        goal_prev_xy=paths[:, -2, :].copy(),
        traffic_route_ids=np.zeros((0,), dtype=np.int32),
        layout=layout,
    )
    tr = table.route_ids(default_traffic_routes(layout))
    object.__setattr__(table, "traffic_route_ids", tr)
    return table
