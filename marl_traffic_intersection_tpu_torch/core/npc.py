"""NPC traffic: a fixed-slot pool with spawn, P/ACC/ghost-scan control,
ordered collision removal and despawn, over an explicit batch of envs.

Counterpart of marl_traffic_intersection_tpu/core/npc.py (reference:
cpp/TrafficFlow.cpp). Every tensor of ``NpcState`` has the env axis B first
and the slot axis M second; a spawn writes the first free slot, a despawn
clears its ``alive`` bit, and ``uid`` (insertion order) stands in for the
reference's vector order.

The reference moves NPCs one at a time in vector order, each seeing the
already-moved poses of those before it (TrafficFlow.cpp:337-344). Three
pipelines carry that:

  * ``npc_traffic_update_serial`` is the direct transcription: M rounds, one
    slot per env per round, in uid order (the ground truth);
  * ``npc_traffic_update`` (the default, "exact") plans every slot at once
    against the pre-tick poses, writes the slots with no interacting
    earlier neighbour, and replays the dependent rest, one slot per env per
    round (``slot``) or every slot whose earlier neighbours are settled
    (``wave``); bit-equal to the serial pipeline;
  * ``npc_traffic_update_fast`` plans and moves every slot against the
    pre-tick poses (a synchronous approximation).

The JAX package's ``while_loop``s run, under vmap, until no env has work
left; here the loops do the same and read the device once per round to
decide (``pending.any()``), except the ``slot`` cleanup, whose round count is
the batch's largest dependent count, read once. The optional ``stats``
counter (the env's ``npc_stats``, core/env.py) counts the reads
(``host_reads``), the rounds of each loop (``cleanup_rounds``,
``collision_rounds``) and, per tick, the loops' rounds together
(``npc_rounds_at_<n>``: one more tick whose cleanup and cascade ran n
rounds). Each read goes through ``host_read`` (utils/graphs.py), which
tells the segment runner its cause (``cleanup``, ``cascade``): a graphed
runner times from there the device's idle until its next replay
(``Segments``), the eager one keeps counts only.

Each loop is a device start, a round that updates the carried state in
place (``cleanup_round_``, ``cascade_round_``) and a host loop that reads
the device to decide how many rounds run (``run_cleanup``,
``run_cascade``). ``exact_segments`` strings them into the exact tick up to
its despawn, every device part run by a segment runner (utils/graphs.py):
``EAGER`` calls it, the graphed step (envs/vector.py, ``Segments``) replays
a CUDA graph of it, so both run one body and make the same reads.

The float chain is the reference's, as everywhere in the port: trig,
``atan2f`` and ``hypotf`` from ops/libm.py, correctly rounded square roots,
each product rounded before its add, divisions by tensors. Row fetches are
index gathers, which keep a -0.0 spawn heading. On the card every set of
planners (``_move``: the plan, the physics tick and the path index) is one
launch of kernel K2 (ops/npc_move_cuda.py) on that chain; ``move_ref``, its
plain version, is what the CPU runs.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import libm
from ..ops.npc_move_cuda import npc_move
from ..utils.graphs import EAGER, host_read
from .constants import (CAR_LENGTH, CAR_WIDTH, HEIGHT, LANE_WIDTH_PX, PATH_LEN,
                        PHYSICS_MAX_SPEED, PI_F, WIDTH)
from .physics import (car_corners, car_physics_step, sat_overlap,
                      update_path_index, wrap_angle)

_f = np.float32
_PI32 = _f(PI_F)
_DEG45 = float(_f(45.0) * _PI32 / _f(180.0))
_DEG60 = float(_f(60.0) * _PI32 / _f(180.0))
_DEG30 = float(_f(30.0) * _PI32 / _f(180.0))
_DEG150 = float(_f(150.0) * _PI32 / _f(180.0))
_TWO_PI = float(_f(2.0) * _PI32)
_SAFE_RADIUS_SQ = float(_f(CAR_WIDTH * 2.0) * _f(CAR_WIDTH * 2.0))   # 48 px, squared
_SCAN_STEPS = 120
_CX = float(_f(WIDTH * 0.5))
_CY = float(_f(HEIGHT * 0.5))
_UID_MAX = int(np.iinfo(np.int32).max)
_TARGET_SPEED = _f(PHYSICS_MAX_SPEED * 0.4)
_TARGET_SPEED_HI = float(_TARGET_SPEED + _f(1.0))
_TARGET_SPEED = float(_TARGET_SPEED)
_SIDEWAYS = float(_f(LANE_WIDTH_PX * 1.5))
_NOT_FAR = float(_f(CAR_LENGTH * 2.0))
_STABLE = float(_f(LANE_WIDTH_PX * 0.5))
_MIN_SPAWN_D2 = float(_f(CAR_LENGTH * 2.5) ** 2)
_EPS = float(_f(1e-5))
_DOT_MIN = float(_f(0.8))
_COAST, _EASE, _SOFT, _HARD = (float(_f(c)) for c in (-0.1, -0.2, -0.8, -1.0))

# the conservative interaction graph (see npc_controller_update)
_ACC_REACH_SQ = float(_f((80.0 + PHYSICS_MAX_SPEED + 1.0) ** 2))
_SCAN_REACH = _f(float(_f(CAR_WIDTH * 2.0)) + PHYSICS_MAX_SPEED + 1.0)
_SCAN_REACH_SQ = float(_SCAN_REACH * _SCAN_REACH)
_CHUNK = 16


class NpcState(NamedTuple):
    """Fixed-slot NPC pool: every field (B, M) except ``next_uid`` (B,)."""

    alive: torch.Tensor           # bool
    x: torch.Tensor               # f32
    y: torch.Tensor
    v: torch.Tensor
    heading: torch.Tensor
    steering_angle: torch.Tensor
    route_id: torch.Tensor        # int32
    path_index: torch.Tensor      # int32
    uid: torch.Tensor             # int32: insertion order; dead slots keep a stale one
    next_uid: torch.Tensor        # (B,) int32


def init_npc_state(num_envs: int, max_npcs: int, device,
                   next_uid: Optional[torch.Tensor] = None) -> NpcState:
    """An empty pool; ``next_uid`` may pass in the (B,) int32 zero uid counter."""
    z = torch.zeros((num_envs, max_npcs), dtype=torch.float32, device=device)
    zi = torch.zeros((num_envs, max_npcs), dtype=torch.int32, device=device)
    if next_uid is None:
        next_uid = torch.zeros((num_envs,), dtype=torch.int32, device=device)
    return NpcState(alive=torch.zeros((num_envs, max_npcs), dtype=torch.bool, device=device),
                    x=z, y=z, v=z, heading=z, steering_angle=z, route_id=zi, path_index=zi,
                    uid=zi, next_uid=next_uid)


def spawn_decision(generator: torch.Generator, num_envs: int, num_traffic_routes: int,
                   density: float, dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per env, ``(do_try, route_choice)`` drawn from ``generator``: a uniform
    below ``1 - exp(-density * dt)`` (float32, TrafficFlow.cpp:321-328), then
    a uniform route (TrafficFlow.cpp:275-279)."""
    dev = generator.device
    u = torch.rand((num_envs,), generator=generator, device=dev)
    do_try = u < float(_f(1.0) - np.exp(-_f(density) * _f(dt)))
    route_choice = torch.randint(max(num_traffic_routes, 1), (num_envs,), generator=generator,
                                 device=dev, dtype=torch.int32)
    return do_try, route_choice


def _count(stats: Optional[collections.Counter], loop: str, rounds: int, reads: int) -> None:
    if stats is not None:
        stats["host_reads"] += reads
        stats[f"{loop}_rounds"] += rounds


# ------------------------------------------------------------------ planner

def _plan(sx, sy, sv, sh, su, others, pi0, path, pool):
    """Plan S NPCs per env (TrafficFlow.cpp:50-196): ``(throttle, steer)``, (B, S).

    sx, sy, sv, sh, su, pi0: (B, S) the planners' own pose, uid and refreshed
    path index; others: (B, S, M) the alive slots each planner looks at;
    path: (B, S, P, 2) each planner's polyline; pool = (x, y, v, heading,
    uid), each (B, M), the slots' current poses.
    """
    x, y, v, heading, uid = pool
    dev = sx.device

    # 1) lateral: P-control on the heading error to a 12-point lookahead
    tgt = torch.clamp(pi0 + 12, max=PATH_LEN - 1).long()[..., None]
    tx = path[..., 0].gather(-1, tgt)[..., 0]
    ty = path[..., 1].gather(-1, tgt)[..., 0]
    heading_err = wrap_angle(libm.atan2f_diff(ty, sy, tx, sx) - sh)
    steer_cmd = torch.clamp(heading_err * 3.0, -1.0, 1.0)

    # 2) longitudinal: cruise plus front-car braking (TrafficFlow.cpp:66-75)
    acc = torch.where(sv < _TARGET_SPEED, 0.5, torch.where(sv > _TARGET_SPEED_HI, _COAST, 0.0))
    s, c = libm.sincosf(sh)
    vx = c[..., None]                                   # (B, S, 1)
    vy = -s[..., None]
    dx = x[:, None, :] - sx[..., None]                  # (B, S, M)
    dy = y[:, None, :] - sy[..., None]
    dist = libm.hypotf(dx, dy)
    longi = dx * vx + dy * vy
    dot = longi / (dist + _EPS)
    angle_diff = wrap_angle(sh[..., None] - heading[:, None, :]).abs()
    front_ok = others & (dist <= 80.0) & (dot > _DOT_MIN) & (angle_diff < _DEG45)
    front_dist = torch.where(front_ok, dist, 1e9).amin(-1)
    acc = torch.where(front_dist < 30.0, _HARD,
                      torch.where(front_dist < 50.0, torch.clamp(acc, max=_EASE), acc))

    # 3) ghost path scan (TrafficFlow.cpp:77-185) over every path point, the
    # 120-point window from pi0 as a mask
    iota = torch.arange(PATH_LEN, device=dev, dtype=pi0.dtype)
    scan_valid = (iota >= pi0[..., None]) & (iota < pi0[..., None] + _SCAN_STEPS)   # (B, S, P)
    gx, gy = path[..., 0], path[..., 1]
    d2 = x[:, None, :, None] - gx[:, :, None, :]        # (B, S, M, P)
    d2.mul_(d2)
    dyk = y[:, None, :, None] - gy[:, :, None, :]
    dyk.mul_(dyk)
    close = d2.add_(dyk) < _SAFE_RADIUS_SQ
    del d2, dyk

    same_dir = angle_diff < _DEG60
    adn = torch.minimum(angle_diff, _TWO_PI - angle_diff)
    is_parallel = (adn < _DEG30) | (adn > _DEG150)
    lat = libm.sqrtf(torch.clamp(dist * dist - longi * longi, min=0.0))
    sideways = lat.abs() < _SIDEWAYS
    not_far = longi.abs() < _NOT_FAR
    mfx = sx[..., None] + vx * 20.0
    mfy = sy[..., None] + vy * 20.0
    s, c = libm.sincosf(heading)
    ofx = x + c * 20.0
    ofy = y - s * 20.0
    fdx = ofx[:, None, :] - mfx
    fdy = ofy[:, None, :] - mfy
    fmag = libm.hypotf(fdx, fdy)
    flong = fdx * vx + fdy * vy
    flat = libm.sqrtf(torch.clamp(fmag * fmag - flong * flong, min=0.0))
    stable = (flat - lat).abs() < _STABLE
    skip_parallel = (dist > _EPS) & is_parallel & sideways & not_far & (fmag > _EPS) & stable

    # yield rules (TrafficFlow.cpp:162-177): should_yield(k, o) = rule1(k) | rules234(o)
    cx, cy = libm.const(_CX, dev), libm.const(_CY, dev)
    my_dc = libm.hypotf_diff(sx, cx, sy, cy)[..., None]         # (B, S, 1)
    other_dc = libm.hypotf_diff(x, cx, y, cy)[:, None, :]       # (B, 1, M)
    dtc = libm.hypotf_diff(gx, sx[..., None], gy, sy[..., None])  # (B, S, P)
    rule1 = dtc < 15.0
    rule2 = (sv < 1.0)[..., None] & (v > 3.0)[:, None, :] & (other_dc < my_dc + 25.0)
    rule3 = other_dc < my_dc - 5.0
    rule4 = ((other_dc - my_dc).abs() <= 5.0) & (su[..., None] < uid[:, None, :])
    okm = others & ~same_dir & ~skip_parallel                        # (B, S, M)
    any_considered = (close & okm[..., None]).any(2)                 # (B, S, P)
    any_rule234 = (close & (okm & (rule2 | rule3 | rule4))[..., None]).any(2)
    point_conflict = scan_valid & ((rule1 & any_considered) | any_rule234)

    conflict = point_conflict.any(-1)
    first_k = point_conflict.to(torch.uint8).argmax(-1, keepdim=True)   # first conflict
    min_conflict_dist = dtc.gather(-1, first_k)[..., 0]

    # 4) combine (TrafficFlow.cpp:187-195)
    braked = torch.where(min_conflict_dist < 35.0, _HARD,
                         torch.where(min_conflict_dist < 60.0, _SOFT,
                                     torch.clamp(acc, max=0.0)))
    throttle = torch.where(conflict, braked, acc)
    return throttle, steer_cmd


class _Moved(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    v: torch.Tensor
    heading: torch.Tensor
    steering_angle: torch.Tensor
    path_index: torch.Tensor


def move_ref(sx, sy, sv, sh, ss, su, pi0, path, others, pool, dt) -> _Moved:
    """Plan, integrate and re-index the given planners (all (B, S)): the
    plain version of kernel K2 (ops/npc_move_cuda.py), which the CPU runs
    and the tests and chip_smoke.py hold the kernel to."""
    th, st = _plan(sx, sy, sv, sh, su, others, pi0, path, pool)
    o = car_physics_step(sx, sy, sv, sh, ss, th, st, dt)
    pi1 = update_path_index(path, PATH_LEN, pi0, o.x, o.y)
    return _Moved(o.x, o.y, o.v, o.heading, o.steering_angle, pi1)


def _move(sx, sy, sv, sh, ss, su, pi0, path, others, pool, dt) -> _Moved:
    """``move_ref``: on the CPU itself, on the card one launch of K2."""
    if sx.device.type == "cpu":
        return move_ref(sx, sy, sv, sh, ss, su, pi0, path, others, pool, dt)
    return _Moved(*npc_move(sx, sy, sv, sh, ss, su, pi0, path, others, pool, dt))


def _poses(npc: NpcState) -> _Moved:
    return _Moved(npc.x, npc.y, npc.v, npc.heading, npc.steering_angle, npc.path_index)


def _write(mask, new: _Moved, cur: _Moved) -> _Moved:
    return _Moved(*(torch.where(mask, a, b) for a, b in zip(new, cur)))


def _write_(mask, new: _Moved, cur: _Moved) -> None:
    """``_write`` into ``cur``'s tensors."""
    for a, b in zip(new, cur):
        torch.where(mask, a, b, out=b)


def _pool(cur: _Moved, uid):
    return cur.x, cur.y, cur.v, cur.heading, uid


def _take(a: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``a[b, slot[b]]`` as (B, 1)."""
    return a.gather(1, slot[:, None])


def _slot_path(paths, slot):
    """Slot ``slot[b]``'s polyline of every env, (B, 1, P, 2)."""
    return paths[torch.arange(slot.shape[0], device=slot.device), slot][:, None]


def _move_slot(cur: _Moved, npc: NpcState, path, pi0, slot, oh, dt) -> _Moved:
    """Plan and integrate slot ``slot[b]`` of every env (``oh`` its one-hot,
    ``path`` and ``pi0`` its polyline and refreshed path index) against ``cur``."""
    return _move(_take(cur.x, slot), _take(cur.y, slot), _take(cur.v, slot),
                 _take(cur.heading, slot), _take(cur.steering_angle, slot),
                 _take(npc.uid, slot), pi0, path, (npc.alive & ~oh)[:, None],
                 _pool(cur, npc.uid), dt)


def _with(npc: NpcState, cur: _Moved) -> NpcState:
    return npc._replace(**cur._asdict())


def _eye(m: int, device) -> torch.Tensor:
    return torch.eye(m, dtype=torch.bool, device=device)


# --------------------------------------------------------------- controllers

def npc_controller_update_serial(npc: NpcState, paths_table, dt) -> NpcState:
    """The reference's one-NPC-at-a-time pass in uid order
    (TrafficFlow.cpp:330-344), one slot per env per round; the ground truth
    of ``npc_controller_update``."""
    M = npc.alive.shape[1]
    perm = torch.argsort(torch.where(npc.alive, npc.uid, _UID_MAX), dim=1, stable=True)
    paths = paths_table[npc.route_id.long()]                      # (B, M, P, 2)
    slots = torch.arange(M, device=npc.alive.device)
    cur = _poses(npc)
    for p in range(M):
        slot = perm[:, p]
        oh = slots == slot[:, None]
        path = _slot_path(paths, slot)
        pi0 = update_path_index(path, PATH_LEN, _take(cur.path_index, slot),
                                _take(cur.x, slot), _take(cur.y, slot))
        cur = _write(oh & _take(npc.alive, slot),
                     _move_slot(cur, npc, path, pi0, slot, oh, dt), cur)
    return _with(npc, cur)


def _interaction_graph(npc: NpcState, paths, pi0) -> torch.Tensor:
    """Symmetric conservative could-read matrix (B, M, M) from pre-tick poses:
    within ACC reach (80 + 8 + 1 px), or within ghost-scan reach (48 + 8 + 1
    px) of a 16-point chunk AABB of the other's scan window."""
    B, M = npc.alive.shape
    x, y = npc.x, npc.y
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    acc_reach = dx * dx + dy * dy <= _ACC_REACH_SQ

    nchunk = PATH_LEN // _CHUNK
    pc = paths.reshape(B, M, nchunk, _CHUNK, 2)
    cmin, cmax = pc.amin(3), pc.amax(3)                            # (B, M, C, 2)
    cstart = torch.arange(nchunk, device=x.device, dtype=pi0.dtype) * _CHUNK
    win = ((cstart + _CHUNK > pi0[..., None])
           & (cstart < pi0[..., None] + _SCAN_STEPS))              # (B, M, C)
    ox = x[:, None, None, :]
    oy = y[:, None, None, :]
    ddx = torch.clamp(torch.maximum(cmin[..., 0, None] - ox, ox - cmax[..., 0, None]), min=0.0)
    ddy = torch.clamp(torch.maximum(cmin[..., 1, None] - oy, oy - cmax[..., 1, None]), min=0.0)
    near = ddx * ddx + ddy * ddy <= _SCAN_REACH_SQ                 # (B, M, C, M)
    scan_reach = (win[..., None] & near).any(2)                    # [j, i]: i near j's scan
    both = npc.alive[:, :, None] & npc.alive[:, None, :]
    return (acc_reach | scan_reach | scan_reach.transpose(1, 2)) & both & ~_eye(M, x.device)


class ExactCarry(NamedTuple):
    """What the exact controller's cleanup rounds carry: the pool planned
    for, its polylines (B, M, P, 2), refreshed path indices, the could-read
    order ``before`` ([i, j]: i interacts with j and precedes it), the slots
    each slot looks at, the poses written so far and the dependent slots
    not yet replayed."""

    npc: NpcState
    paths: torch.Tensor
    pi0: torch.Tensor
    before: torch.Tensor
    others: torch.Tensor
    cur: _Moved
    pending: torch.Tensor


def controller_begin(npc: NpcState, paths_table, dt) -> ExactCarry:
    """The exact pass's dense plan: every slot planned against the pre-tick
    poses, those with no interacting earlier neighbour written."""
    M = npc.alive.shape[1]
    dev = npc.alive.device
    paths = paths_table[npc.route_id.long()]                      # (B, M, P, 2)
    pi0 = update_path_index(paths, PATH_LEN, npc.path_index, npc.x, npc.y)
    interact = _interaction_graph(npc, paths, pi0)
    earlier = npc.uid[:, :, None] < npc.uid[:, None, :]
    before = interact & earlier                                    # [i, j]: i before j
    dependent = npc.alive & before.any(1)

    others = npc.alive[:, None, :] & ~_eye(M, dev)
    cur = _poses(npc)
    cur = _write(npc.alive & ~dependent,
                 _move(npc.x, npc.y, npc.v, npc.heading, npc.steering_angle, npc.uid, pi0,
                       paths, others, _pool(cur, npc.uid), dt), cur)
    return ExactCarry(npc, paths, pi0, before, others, cur, dependent)


def cleanup_round_(c: ExactCarry, wave: bool, dt) -> None:
    """One cleanup round, in place on ``c.cur`` and ``c.pending``: ``wave``
    replays every pending slot whose interacting earlier neighbours are
    settled, from one dense plan; ``slot`` the lowest-uid pending slot of
    each env. A round with nothing pending writes nothing."""
    npc, cur, pending = c.npc, c.cur, c.pending
    if wave:
        ready = pending & ~(c.before & pending[:, :, None]).any(1)
        new = _move(cur.x, cur.y, cur.v, cur.heading, cur.steering_angle, npc.uid, c.pi0,
                    c.paths, c.others, _pool(cur, npc.uid), dt)
    else:
        slot = torch.where(pending, npc.uid, _UID_MAX).argmin(1)
        ready = pending & (torch.arange(pending.shape[1], device=slot.device) == slot[:, None])
        new = _move_slot(cur, npc, _slot_path(c.paths, slot), _take(c.pi0, slot), slot, ready,
                         dt)
    _write_(ready, new, cur)
    pending &= ~ready


def run_cleanup(c: ExactCarry, wave: bool, round_, stats: Optional[collections.Counter] = None,
                run=EAGER) -> int:
    """The cleanup loop on the host: ``round_()`` runs one round on ``c``;
    ``wave`` reads ``pending.any()`` before each round, ``slot`` the batch's
    largest dependent count once; each read through ``host_read`` on
    ``run``. Returns the rounds."""
    if wave:
        rounds = 0
        while host_read(run, "cleanup", c.pending.any().item):
            round_()
            rounds += 1
        _count(stats, "cleanup", rounds, rounds + 1)
    else:
        rounds = host_read(run, "cleanup", c.pending.sum(1).max().item) \
            if c.pending.shape[0] else 0
        for _ in range(rounds):
            round_()
        _count(stats, "cleanup", rounds, 1)
    return rounds


def npc_controller_update(npc: NpcState, paths_table, dt, wave_cleanup: bool = False,
                          stats: Optional[collections.Counter] = None) -> NpcState:
    """Exact controller pass, bit-equal to ``npc_controller_update_serial``.

    A plan reads another NPC's pose only within 80 px (ACC) or 48 px of a
    scan point, and a pose moves at most 8 px per tick, so a slot with no
    interacting earlier-uid neighbour in the pre-tick graph plans the same
    against the pre-tick poses as in the serial order. One dense pass plans
    every slot and writes those; the dependent slots are replayed:
      * ``slot``: one per env per round, lowest uid first; rounds = the
        batch's largest dependent count (one device read);
      * ``wave``: per round, every pending slot whose interacting earlier
        neighbours are settled (they never interact with each other), each
        round a dense plan; rounds = the batch's deepest chain, one read each.
    """
    c = controller_begin(npc, paths_table, dt)
    run_cleanup(c, wave_cleanup, lambda: cleanup_round_(c, wave_cleanup, dt), stats)
    return _with(npc, c.cur)


def npc_controller_update_fast(npc: NpcState, paths_table, dt) -> NpcState:
    """Synchronous pass: every slot plans against the pre-tick poses and they
    integrate together (differs from the exact pass through same-tick pose
    deltas only)."""
    M = npc.alive.shape[1]
    paths = paths_table[npc.route_id.long()]
    pi0 = update_path_index(paths, PATH_LEN, npc.path_index, npc.x, npc.y)
    others = npc.alive[:, None, :] & ~_eye(M, npc.alive.device)
    cur = _poses(npc)
    new = _move(npc.x, npc.y, npc.v, npc.heading, npc.steering_angle, npc.uid, pi0, paths,
                others, _pool(cur, npc.uid), dt)
    return _with(npc, _write(npc.alive, new, cur))


# ---------------------------------------------------------------- collisions

def _collide(npc: NpcState) -> torch.Tensor:
    corners = car_corners(npc.x, npc.y, npc.heading)               # (B, M, 4, 2)
    return sat_overlap(corners[:, :, None], npc.heading[:, :, None],
                       corners[:, None, :], npc.heading[:, None, :])   # (B, M, M)


def npc_collisions_serial(npc: NpcState) -> NpcState:
    """Ordered pairwise removal (TrafficFlow.cpp:346-356): in uid order, row i
    kills every later still-alive j it overlaps, and dies itself if any."""
    M = npc.alive.shape[1]
    collide = _collide(npc)
    later = npc.uid[:, :, None] < npc.uid[:, None, :]
    perm = torch.argsort(torch.where(npc.alive, npc.uid, _UID_MAX), dim=1, stable=True)
    slots = torch.arange(M, device=npc.alive.device)
    alive = npc.alive
    for p in range(M):
        i = perm[:, p]
        oh = slots == i[:, None]
        row = torch.arange(i.shape[0], device=i.device)
        j_kill = _take(alive, i) & alive & later[row, i] & collide[row, i]
        alive = alive & ~j_kill
        alive = torch.where(oh, alive & ~j_kill.any(1, keepdim=True), alive)
    return npc._replace(alive=alive)


class Cascade(NamedTuple):
    """What the collision cascade's rounds carry: ``killing`` (B, M, M)
    ([i, j]: i overlaps j and precedes it), the alive bits and the rows
    that still kill."""

    killing: torch.Tensor
    alive: torch.Tensor
    k: torch.Tensor


def _killers(killing, alive):
    return (killing & alive[:, None, :]).any(2) & alive


def cascade_begin(npc: NpcState) -> Cascade:
    """The cascade's start: the overlaps, a copy of the alive bits, the
    first round's killers."""
    killing = _collide(npc) & (npc.uid[:, :, None] < npc.uid[:, None, :])
    alive = npc.alive.clone()
    return Cascade(killing, alive, _killers(killing, alive))


def cascade_round_(c: Cascade, uid) -> None:
    """One killer row per env, the lowest uid first, in place on ``c.alive``
    and ``c.k``; a round with no killer writes nothing."""
    alive = c.alive
    first_uid = torch.where(c.k, uid, _UID_MAX).amin(1, keepdim=True)
    is_i = c.k & (uid == first_uid)
    victims = (c.killing & is_i[:, :, None]).any(1) & alive
    alive &= ~victims
    alive &= ~is_i
    torch.logical_and((c.killing & alive[:, None, :]).any(2), alive, out=c.k)


def run_cascade(c: Cascade, round_, stats: Optional[collections.Counter] = None,
                run=EAGER) -> int:
    """The cascade's loop on the host: ``k.any()`` read before each round,
    through ``host_read`` on ``run``. Returns the rounds."""
    rounds = 0
    while host_read(run, "cascade", c.k.any().item):
        round_()
        rounds += 1
    _count(stats, "collision", rounds, rounds + 1)
    return rounds


def npc_collisions(npc: NpcState, stats: Optional[collections.Counter] = None) -> NpcState:
    """Killer-row cascade, bit-equal to ``npc_collisions_serial``: only rows
    that overlap a later alive row change anything, so those alone are
    processed, lowest uid first, with the alive bits recomputed each round."""
    c = cascade_begin(npc)
    run_cascade(c, lambda: cascade_round_(c, npc.uid), stats)
    return npc._replace(alive=c.alive)


def npc_collisions_fast(npc: NpcState) -> NpcState:
    """Synchronous removal: every alive NPC overlapping another alive one dies."""
    M = npc.alive.shape[1]
    hit = (_collide(npc) & ~_eye(M, npc.alive.device) & npc.alive[:, None, :]).any(-1)
    return npc._replace(alive=npc.alive & ~(hit & npc.alive))


# ------------------------------------------------------------ spawn, despawn

def npc_despawn(npc: NpcState, goal_xy) -> NpcState:
    """Remove NPCs within 20 px of their goal or 100 px off the screen
    (TrafficFlow.cpp:358-366). goal_xy: (R, 2)."""
    g = goal_xy[npc.route_id.long()]
    arrived = libm.hypotf_diff(npc.x, g[..., 0], npc.y, g[..., 1]) < 20.0
    oos = ((npc.x < -100.0) | (npc.x > WIDTH + 100.0)
           | (npc.y < -100.0) | (npc.y > HEIGHT + 100.0))
    return npc._replace(alive=npc.alive & ~arrived & ~oos)


def npc_try_spawn(npc: NpcState, do_try, route_choice, ego_x, ego_y, ego_present,
                  traffic_route_ids, spawn_xy, spawn_heading) -> Tuple[NpcState, torch.Tensor]:
    """One spawn attempt per env (TrafficFlow.cpp:240-315): blocked within
    2.5 car lengths of any present ego or alive NPC; writes the first free
    slot. do_try (B,) bool, route_choice (B,) int; ego_* (B, N). Returns
    ``(state, spawned)``."""
    B, M = npc.alive.shape
    T = traffic_route_ids.shape[0]
    if T == 0 or M == 0:
        return npc, torch.zeros((B,), dtype=torch.bool, device=npc.alive.device)
    rid = traffic_route_ids[torch.clamp(route_choice.long(), 0, T - 1)]      # (B,)
    sxy = spawn_xy[rid.long()]
    sx, sy = sxy[:, 0:1], sxy[:, 1:2]

    def near(px, py):
        ex, ey = px - sx, py - sy
        return ex * ex + ey * ey < _MIN_SPAWN_D2

    blocked = ((ego_present & near(ego_x, ego_y)).any(1)
               | (npc.alive & near(npc.x, npc.y)).any(1))
    free = ~npc.alive
    slot = free.to(torch.uint8).argmax(1)
    spawned = do_try.to(torch.bool) & ~blocked & free.any(1)
    w = spawned[:, None] & (torch.arange(M, device=slot.device) == slot[:, None])

    def put(a, val):
        return torch.where(w, val, a)

    rid1 = rid[:, None].to(torch.int32)
    npc = NpcState(
        alive=npc.alive | w, x=put(npc.x, sx), y=put(npc.y, sy), v=put(npc.v, 0.0),
        heading=put(npc.heading, spawn_heading[rid.long()][:, None]),
        steering_angle=put(npc.steering_angle, 0.0), route_id=put(npc.route_id, rid1),
        path_index=put(npc.path_index, 0).to(torch.int32),
        uid=put(npc.uid, npc.next_uid[:, None]),
        next_uid=(npc.next_uid + spawned.to(torch.int32)).to(torch.int32))
    return npc, spawned


# ----------------------------------------------------------------- pipelines

def exact_begin(npc: NpcState, paths_table, spawn_xy, spawn_heading, traffic_route_ids, ego_x,
                ego_y, ego_present, do_try, route_choice, dt) -> Tuple[ExactCarry, torch.Tensor]:
    """The exact tick's first segment: the spawn attempt and the dense plan,
    ``(carry, spawned)``."""
    npc, spawned = npc_try_spawn(npc, do_try, route_choice, ego_x, ego_y, ego_present,
                                 traffic_route_ids, spawn_xy, spawn_heading)
    return controller_begin(npc, paths_table, dt), spawned


def exact_segments(begin, inputs: tuple, wave: bool, dt,
                   stats: Optional[collections.Counter] = None, run=EAGER, key: tuple = ()):
    """The exact tick up to its despawn, each device part run by ``run`` under
    ``key`` + its name, the host's loops between them: ``begin(*inputs)`` (the
    spawn attempt and the dense plan, ``exact_begin``), the cleanup rounds,
    the cascade's start and its rounds; ``stats`` counts the tick in
    ``npc_rounds_at_<n>``, n its cleanup and cascade rounds together.
    Returns the carries ``(carry, spawned, cascade)`` that ``exact_end``
    finishes."""
    c, spawned = run.carry(key + ("npc begin",), begin, *inputs)
    rounds = run_cleanup(c, wave, lambda: run(key + ("npc cleanup", "wave" if wave else "slot"),
                                              lambda c: cleanup_round_(c, wave, dt), c),
                         stats, run)
    k = run.carry(key + ("npc cascade",), lambda c: cascade_begin(_with(c.npc, c.cur)), c)
    rounds += run_cascade(k, lambda: run(key + ("npc cascade round",), cascade_round_, k,
                                         c.npc.uid), stats, run)
    if stats is not None:
        stats[f"npc_rounds_at_{rounds}"] += 1
    return c, spawned, k


def exact_end(carries, goal_xy) -> Tuple[NpcState, torch.Tensor]:
    """The tick's pool after the despawn, and ``spawned``, from
    ``exact_segments``' carries."""
    c, spawned, k = carries
    return npc_despawn(_with(c.npc, c.cur)._replace(alive=k.alive), goal_xy), spawned


def npc_traffic_update(npc: NpcState, paths_table, goal_xy, spawn_xy, spawn_heading,
                       traffic_route_ids, ego_x, ego_y, ego_present, do_try, route_choice,
                       dt, wave_cleanup: bool = False,
                       stats: Optional[collections.Counter] = None):
    """One tick of traffic (TrafficFlow.cpp:318-367): spawn attempt, the
    exact controller pass, ordered collision removal, despawn."""
    args = (npc, paths_table, spawn_xy, spawn_heading, traffic_route_ids, ego_x, ego_y,
            ego_present, do_try, route_choice, dt)
    return exact_end(exact_segments(exact_begin, args, wave_cleanup, dt, stats), goal_xy)


def npc_traffic_update_serial(npc: NpcState, paths_table, goal_xy, spawn_xy, spawn_heading,
                              traffic_route_ids, ego_x, ego_y, ego_present, do_try,
                              route_choice, dt):
    """The tick with the reference's sequential loops (the ground truth)."""
    npc, spawned = npc_try_spawn(npc, do_try, route_choice, ego_x, ego_y, ego_present,
                                 traffic_route_ids, spawn_xy, spawn_heading)
    npc = npc_controller_update_serial(npc, paths_table, dt)
    npc = npc_collisions_serial(npc)
    return npc_despawn(npc, goal_xy), spawned


def npc_traffic_update_fast(npc: NpcState, paths_table, goal_xy, spawn_xy, spawn_heading,
                            traffic_route_ids, ego_x, ego_y, ego_present, do_try,
                            route_choice, dt):
    """The tick with the synchronous controller and collision passes."""
    npc, spawned = npc_try_spawn(npc, do_try, route_choice, ego_x, ego_y, ego_present,
                                 traffic_route_ids, spawn_xy, spawn_heading)
    npc = npc_controller_update_fast(npc, paths_table, dt)
    npc = npc_collisions_fast(npc)
    return npc_despawn(npc, goal_xy), spawned
