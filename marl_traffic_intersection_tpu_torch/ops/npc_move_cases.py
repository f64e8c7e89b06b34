"""Seeded inputs on which kernel K2 is held against its plain version.

Each ``*_args`` function returns the arguments of core/npc.py::move_ref as
CPU tensors (``on`` moves them to a device): the planners' x, y, v, heading,
steering angle, uid, refreshed path index, polylines, the slots each looks
at, the pool's (x, y, v, heading, uid) and dt. chip_smoke.py and the card
tests feed them to the kernel, the CPU tests to the CPU build of its body
(csrc/npc_move_host.cpp).

``pool`` is tests/test_torch_npc.py's seeded pool at any batch and width:
cars on their routes' middle sections, where the ghost scans and the
front-car checks interact, some pushed onto each other (chains). The dense
arguments plan every slot against its pool, as the exact controller's first
pass; the slot arguments plan one slot per env, the lowest-uid pending one,
as a ``slot`` cleanup round. ``edge_args`` builds the cases a pool rarely
holds: a tie in the path-index window, a -0.0 heading, a car at the ghost
scan's radius, and cars near the first and last points of the scan window
and just outside it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.constants import PATH_LEN
from ..core.npc import move_ref
from ..core.physics import update_path_index
from ..core.routes import build_route_table

DT = np.float32(1.0 / 60.0)
_UID_MAX = int(np.iinfo(np.int32).max)


@functools.lru_cache(maxsize=1)
def route_table():
    return build_route_table(3)


def pool(seed: int, envs: int, slots: int, p_alive: float = 0.6, overlaps: int = 0) -> dict:
    """An NPC pool of ``envs`` x ``slots`` as numpy arrays (NpcState's fields
    but ``next_uid``): ``overlaps`` cars per env pushed onto their
    neighbours."""
    table = route_table()
    rng = np.random.RandomState(seed)
    ids = table.traffic_route_ids
    route = ids[rng.randint(len(ids), size=(envs, slots))].astype(np.int32)
    pi = rng.randint(35, 125, size=(envs, slots)).astype(np.int32)
    here, ahead = table.paths[route, pi], table.paths[route, pi + 1]
    heading = np.arctan2(-(ahead[..., 1] - here[..., 1]), ahead[..., 0] - here[..., 0])
    f = np.float32
    st = dict(
        alive=rng.uniform(size=(envs, slots)) < p_alive,
        x=(here[..., 0] + rng.normal(0, 3, (envs, slots))).astype(f),
        y=(here[..., 1] + rng.normal(0, 3, (envs, slots))).astype(f),
        v=rng.uniform(0, 8, (envs, slots)).astype(f),
        heading=(heading + rng.normal(0, 0.1, (envs, slots))).astype(f),
        steering_angle=rng.uniform(-0.3, 0.3, (envs, slots)).astype(f),
        route_id=route, path_index=(pi - rng.randint(0, 3, (envs, slots))).astype(np.int32),
        uid=np.stack([rng.permutation(slots) + 5 for _ in range(envs)]).astype(np.int32))
    for b in range(envs):
        for j in rng.choice(slots - 1, overlaps, replace=False):
            st["x"][b, j + 1] = st["x"][b, j] + f(rng.uniform(-20, 20))
            st["y"][b, j + 1] = st["y"][b, j] + f(rng.uniform(-8, 8))
            st["alive"][b, j:j + 2] = True
    return st


def _tensors(st: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in st.items()}


def _refreshed(t: dict) -> tuple:
    paths = torch.from_numpy(route_table().paths)[t["route_id"].long()]      # (B, M, P, 2)
    return paths, update_path_index(paths, PATH_LEN, t["path_index"], t["x"], t["y"])


def dense_args(st: dict) -> tuple:
    """Every slot planned against its pool (core/npc.py::controller_begin)."""
    t = _tensors(st)
    paths, pi0 = _refreshed(t)
    M = t["alive"].shape[1]
    others = t["alive"][:, None, :] & ~torch.eye(M, dtype=torch.bool)
    return (t["x"], t["y"], t["v"], t["heading"], t["steering_angle"], t["uid"], pi0, paths,
            others, (t["x"], t["y"], t["v"], t["heading"], t["uid"]), torch.tensor(DT))


def slot_args(st: dict, seed: int) -> tuple:
    """One slot per env, the lowest-uid one of a seeded pending set of alive
    slots (core/npc.py::cleanup_round_ with ``wave`` false)."""
    t = _tensors(st)
    paths, pi0 = _refreshed(t)
    B, M = t["alive"].shape
    rng = np.random.RandomState(seed)
    pending = t["alive"] & torch.from_numpy(rng.uniform(size=(B, M)) < 0.5)
    slot = torch.where(pending, t["uid"], _UID_MAX).argmin(1)
    ready = pending & (torch.arange(M) == slot[:, None])

    def take(a):
        return a.gather(1, slot[:, None])

    return (take(t["x"]), take(t["y"]), take(t["v"]), take(t["heading"]),
            take(t["steering_angle"]), take(t["uid"]), take(pi0),
            paths[torch.arange(B), slot][:, None], (t["alive"] & ~ready)[:, None],
            (t["x"], t["y"], t["v"], t["heading"], t["uid"]), torch.tensor(DT))


# edge_args' envs, one planner each (slot 0) and one other car (slot 1); a
# "not looked at" env is the one before it with the car's flag off
_WINDOW_ENDS = ("car near the window's last point", "car near the point after the window",
                "car near the window's first point", "car near the point before the window")
EDGE_ENVS = ("tie", "tie, -0.0 heading", "car 47 px from a point", "car 48 px from a point",
             *(e for end in _WINDOW_ENDS for e in (end, end + ", not looked at")))


def _near_points(car, points) -> np.ndarray:
    """The indices of ``points`` (P, 2) within 48 px of ``car``, by the
    plan's float32 test."""
    ex, ey = np.float32(car[0]) - points[:, 0], np.float32(car[1]) - points[:, 1]
    return np.flatnonzero(ex * ex + ey * ey < np.float32(2304.0))


def edge_args() -> tuple:
    """The envs of EDGE_ENVS:

      * a tie: the planner alone, heading 0 (+0.0 and -0.0) along a straight
        polyline of points 1 px apart, placed so that its tick ends exactly
        half-way between points 60 and 61 (the lower index wins) with its
        lookahead point straight ahead;
      * the ghost scan's radius: on that line, a car across it 47 and 48 px
        from point 100 (only the first is within the strict 48 px);
      * the scan window's ends: a planner at point 10 of a traffic route at
        2 px/frame and a car across the route at point 145, nearer the
        crossing's centre (it has the right of way) and far from the planner
        (not a car to follow); the refreshed index puts the first of the
        points near the car at the window's last point and just after it,
        and the last of them at the window's first point and just before it;
        each also with the car not looked at, so a test can tell whether the
        car changed the move.
    """
    table = route_table()
    f = np.float32
    B, M = len(EDGE_ENVS), 2
    x, y, v, h = (np.zeros((B, M), f) for _ in range(4))
    uid = np.tile(np.asarray([7, 3], np.int32), (B, 1))
    look = np.tile(np.asarray([False, True]), (B, 1))
    paths = np.zeros((B, 1, PATH_LEN, 2), f)
    pi0 = np.zeros((B, 1), np.int32)
    v[:, 0] = 2.0

    # the straight line: the tick with no car near is the same at any x
    line = np.stack([f(40.0) + np.arange(PATH_LEN, dtype=f), np.full(PATH_LEN, f(375.0))], -1)
    paths[:4, 0] = line
    pi0[:2] = 50
    h[1, 0] = -0.0
    look[:2] = False
    moved_v = move_ref(*_finish(x, y, v, h, uid, pi0, paths, look)).v[0, 0].numpy()
    x[:2, 0] = f(f(100.5) - moved_v)
    y[:4, 0] = 375.0
    x[2:4, 0], pi0[2:4] = 50.0, 10
    x[2:4, 1], y[2, 1], y[3, 1], h[2:4, 1] = line[100, 0], 375.0 + 47.0, 375.0 + 48.0, np.pi / 2

    # the scan window's ends: a car across the route at point 145
    route = table.paths[table.traffic_route_ids[0]]
    here, ahead = route[10], route[11]
    car, car_next = route[145], route[146]
    near = _near_points(car, route)
    paths[4:, 0] = route
    x[4:, 0], y[4:, 0] = here[0], here[1]
    h[4:, 0] = np.arctan2(-(ahead[1] - here[1]), ahead[0] - here[0])
    x[4:, 1], y[4:, 1] = car[0], car[1]
    h[4:, 1] = np.arctan2(-(car_next[1] - car[1]), car_next[0] - car[0]) + np.pi / 2
    for i, p in zip(range(4, B, 2), (near[0] - 119, near[0] - 120, near[-1], near[-1] + 1)):
        pi0[i:i + 2] = p
        look[i + 1, 1] = False
    return _finish(x, y, v, h, uid, pi0, paths, look)


def _finish(x, y, v, h, uid, pi0, paths, look) -> tuple:
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in
         dict(x=x, y=y, v=v, h=h, uid=uid, pi0=pi0, paths=paths, look=look).items()}
    mine = [t[k][:, :1].contiguous() for k in ("x", "y", "v", "h")]
    return (*mine, torch.zeros_like(mine[0]), t["uid"][:, :1].contiguous(),
            t["pi0"], t["paths"], t["look"][:, None], (t["x"], t["y"], t["v"], t["h"], t["uid"]),
            torch.tensor(DT))


def on(args: tuple, device) -> tuple:
    """``args`` with every tensor moved to ``device``, made contiguous."""
    return tuple(on(a, device) if isinstance(a, tuple) else a.to(device).contiguous()
                 for a in args)


# (kind, width) of the cases the tests and chip_smoke.py hold K2 to: the
# dense plan and a slot round at each width the traffic path steps, and
# edge_args
CASES = (("dense", 8), ("dense", 16), ("dense", 32), ("slot", 8), ("slot", 16), ("slot", 32),
         ("edges", 2))


def case_args(kind: str, width: int, envs: int = 16) -> tuple:
    """One of CASES on ``envs`` envs: a seeded pool with dead slots, chains
    of overlapping cars and slot 0 heading -0.0, planned densely or one slot
    per env; or edge_args."""
    if kind == "edges":
        return edge_args()
    st = pool(40 + width, envs, width, p_alive=0.7, overlaps=3)
    st["heading"][:, 0] = -0.0
    return dense_args(st) if kind == "dense" else slot_args(st, 50 + width)
