"""Batched environment with auto-reset.

Counterpart of marl_traffic_intersection_tpu/envs/vector.py. The port's env
already steps a batch, so ``VectorEnv`` adds what the batch needs on top:
route sampling at (auto-)reset, the obs-once auto-reset merge (a fresh env
starts with an empty NPC pool), and ``final_obs``.

Random draws come from injectable sources. Routes: by default a
``torch.Generator`` on the env's device (each env draws its agents' routes
from the pool without replacement), or any callable
``route_sampler(num_envs) -> (num_envs, N)`` route-id tensor, which is how
tests replay the JAX package's draws (torch cannot reproduce jax.random
streams). NPC spawns likewise: ``core.npc.spawn_decision`` on the same
generator by default, or ``spawn_sampler(num_envs) -> (do_try,
route_choice)``, each (num_envs,).

With traffic, the NPC pool is narrowed to its live slot prefix, as the JAX
package's ``VectorEnv`` does under ``EnvConfig.npc_tier``. A spawn writes the
first free slot, so the alive slots gather at the front of the pool. When no
env has an alive slot at index w or beyond, and no env has all of its first
w slots alive (a spawn could then write slot w), stepping the pool's
``[:, :w]`` slice and putting the untouched tail back is bit-equal to
stepping the whole pool: dead slots enter the step only through reductions
masked by ``alive``, and the step writes no dead slot. The widths tried are
``npc_tier_widths``'s ladder, the smallest first; the dense ghost-scan plan
shrinks with the square of the width and kernel K1 marches N + w obstacles.

Where the JAX package decides the width on the device under ``lax.cond``,
here the host decides it from one small read at the start of each step: the
batch's highest alive slot and its longest full slot prefix. The stepped
pool has no alive slot at w or beyond (the step wrote none there) and a
fresh pool is empty, so the observation of the merged state and
``final_obs`` use the step's width with no further read. ``env.npc_stats``
(the env's counts and summed seconds; core/env.py lists every key family)
counts these reads in ``host_reads`` and ``tier_reads``, how often each
width ran in ``step_width_<w>`` (w = max_npcs for the full pool), and the
exact NPC update's rounds; the graphed step also sums there, in seconds,
the device's idle after each read by the read's cause
(``read_idle_s.width``, ``.cleanup``, ``.cascade``), where the eager step
keeps the counts only.

A step is ``draws`` (the random draws, eager) then ``step_body`` (the
rest). ``step_body`` is a sequence of device segments between the host's
decisions, each run by a segment runner (utils/graphs.py): the NPC width
read; with the exact NPC mode, its update's segments and loops
(``IntersectionEnv.exact_npc``); then the rest of the step as one segment.
Eagerly (``EAGER``) a segment is a call. ``jit_step`` is the JAX package's:
on the card it replays a CUDA graph of each segment (``Segments``), keyed by
what the host decided (the width, the cleanup schedule, ``final_obs``),
with the same reads and loop rounds as ``step`` and bit-equal to it, where
the JAX package compiles the width ladder and the loops into one program
(``lax.cond``, ``while_loop``).

``with_mesh(mesh)`` (parallel/mesh.py) binds a copy to a device mesh: it
steps this rank's ``num_envs // data ranks`` envs (``num_envs`` stays the
global count) and shares the generator. Every draw that depends on the batch
(routes at reset and auto-reset, NPC spawns; the learners' action noise
likewise) is made for the global batch on every rank from the same
generator, and the rank keeps its rows, so the ranks' states put together
are bit-equal to one process stepping the global batch. The NPC width is
read from the rank's own envs, as the JAX package's shard-local tier conds
are; every width is bit-equal to the full pool, so that choice cannot change
a result.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.constants import DT_DEFAULT
from ..core.env import EnvState, IntersectionEnv
from ..core.npc import NpcState, spawn_decision
from ..core.routes import default_ego_routes
from ..utils.graphs import (EAGER, Segments, clone_tree, copy_tree_, host_read, marked,
                            profiling, stage)


def npc_tier_widths(npc_tier: int, max_npcs: int) -> list:
    """The narrowed widths to try, smallest first (the JAX package's
    ``_tiers``): ``npc_tier`` 0 tries none, > 0 that one width, < 0 (the
    default) max_npcs // 4 then max_npcs // 2; widths outside (0, max_npcs)
    are dropped."""
    if npc_tier == 0:
        widths = []
    elif npc_tier > 0:
        widths = [npc_tier]
    else:
        widths = [max_npcs // 4, max_npcs // 2]
    return sorted({w for w in widths if 0 < w < max_npcs})


def _narrow(state: EnvState, w: Optional[int]) -> EnvState:
    """``state`` with its NPC pool cut to slots ``[:, :w]`` (views); None keeps it."""
    if w is None:
        return state
    return state._replace(npc=NpcState(*(a[:, :w] if a.dim() >= 2 else a for a in state.npc)))


def _widen(narrow: NpcState, full: NpcState, w: Optional[int]) -> NpcState:
    """The stepped ``narrow`` pool with ``full``'s tail slots ``[:, w:]`` put back."""
    if w is None:
        return narrow
    return NpcState(*(torch.cat([a, b[:, w:]], 1) if b.dim() >= 2 else a
                      for a, b in zip(narrow, full)))


class VectorEnv:
    """``num_envs`` auto-reset envs of ``env``'s configuration on its device."""

    def __init__(self, env: IntersectionEnv, num_envs: int,
                 route_pool: Optional[np.ndarray] = None, auto_reset: bool = True,
                 seed: int = 0,
                 route_sampler: Optional[Callable[[int], torch.Tensor]] = None,
                 spawn_sampler: Optional[Callable[[int], Tuple[torch.Tensor,
                                                               torch.Tensor]]] = None):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        if route_pool is None:
            pool = env.table.route_ids(default_ego_routes(
                max(env.config.num_agents, 12), env.config.num_lanes))
            route_pool = np.unique(pool)
        self.route_pool = torch.as_tensor(np.asarray(route_pool, np.int32),
                                          device=env.device)
        self.generator = torch.Generator(device=env.device).manual_seed(seed)
        self.route_sampler = route_sampler or self.sample_routes
        self.spawn_sampler = spawn_sampler
        cfg = env.config
        self.npc_widths = npc_tier_widths(cfg.npc_tier, cfg.max_npcs) if cfg.traffic_flow else []
        self.mesh = None
        self.rows = slice(None)         # this rank's envs of the global batch

    def with_mesh(self, mesh) -> "VectorEnv":
        """A copy stepping this rank's envs of ``mesh``'s data shards (see the
        module docstring); it shares the generator and the samplers."""
        from ..parallel.mesh import data_axis, data_slice
        bound = copy.copy(self)
        bound.mesh, bound.rows = mesh, data_slice(data_axis(mesh), self.num_envs)
        return bound

    def sample_routes(self, num_envs: int) -> torch.Tensor:
        """(num_envs, N) route ids from the pool: without replacement when the
        pool is large enough (duplicate routes share a spawn point, and such
        agents crash into each other at spawn forever), else with."""
        n = self.env.config.num_agents
        p = self.route_pool.shape[0]
        dev = self.env.device
        if p < n:
            idx = torch.randint(p, (num_envs, n), generator=self.generator, device=dev)
        else:
            u = torch.rand((num_envs, p), generator=self.generator, device=dev)
            idx = torch.argsort(u, dim=-1)[:, :n]
        return self.route_pool[idx]

    def reset(self):
        """Batched reset: (state, obs) with leading dim num_envs (this rank's
        envs when bound to a mesh)."""
        state = self.env.reset_state(self.route_sampler(self.num_envs)[self.rows])
        return state, self.env.observe(state)

    def _step_width(self, npc: NpcState, run=EAGER) -> Optional[int]:
        """The smallest width of the ladder at which ``npc`` may be stepped
        (None: the full pool), from one device read (``host_read``, cause
        ``width``, on the segment runner ``run``): no env may have an alive
        slot at w or beyond, nor all of its first w slots alive, since a
        spawn could then write slot w."""
        a = npc.alive.long()
        slot = torch.arange(1, a.shape[1] + 1, device=a.device)
        bounds = torch.stack([(a * slot).amax(), a.cumprod(1).sum(1).amax()])
        hi, full = host_read(run, "width", bounds.tolist)
        stats = self.env.npc_stats
        stats["host_reads"] += 1
        stats["tier_reads"] += 1
        w = next((w for w in self.npc_widths if hi <= w and full < w), None)
        stats[f"step_width_{w or self.env.config.max_npcs}"] += 1
        return w

    def draws(self, dt: float = DT_DEFAULT) -> tuple:
        """The random draws of one step of ``dt``, in the order ``step``
        makes them: ``(spawn, routes)``, the NPC spawn draw (with traffic) and
        the routes of a fresh episode for every env (with auto-reset; the
        step keeps those of the envs whose episode ended); None where the
        configuration makes no such draw."""
        cfg, spawn, routes = self.env.config, None, None
        if cfg.traffic_flow:
            spawn = self.spawn_sampler(self.num_envs) if self.spawn_sampler else \
                spawn_decision(self.generator, self.num_envs, self.env.traffic_ids.shape[0],
                               cfg.traffic_density, dt)
            spawn = tuple(x[self.rows] for x in spawn)
        if self.auto_reset:
            routes = self.route_sampler(self.num_envs)[self.rows]
        return spawn, routes

    def jit_step(self, dt: float = DT_DEFAULT, donate: bool = True):
        """The counterpart of the JAX package's ``VectorEnv.jit_step``: a
        callable ``(state, actions, final_obs=False)`` with ``step``'s
        contract. On the card it replays CUDA graphs of ``step_body``'s
        segments (utils/graphs.py::Segments, one graph per segment and per
        NPC width, cleanup schedule and ``final_obs``; the host reads the
        width and steers the exact NPC mode's loops between them, as
        ``step`` does), after ``draws`` made eagerly (the generator's stream
        and any injected sampler stay as ``step`` uses them) and written
        into a static buffer. On the CPU it runs ``draws`` and ``step_body``
        eagerly, as ``jax.jit`` compiles for the CPU there.

        ``donate=True`` is the JAX donation contract: the returned state
        lives in the graphs' static buffers, so a state passed back in is the
        graphs' own input and is not copied (any other state is copied in),
        and the caller must not reuse the state passed in. The returned
        ``out`` stays valid until the next call. ``donate=False`` returns
        clones of the state and the outputs."""
        if self.env.device.type != "cuda":
            def step(state, actions, final_obs: bool = False):
                return self.step(state, actions, dt, final_obs)
            return step
        return _GraphedStep(self, dt, donate)

    def step(self, state: EnvState, actions: torch.Tensor, dt: float = DT_DEFAULT,
             final_obs: bool = False):
        """Batched step; actions (B, N, 2). Envs whose episode ended start a
        fresh one, and the returned obs is the fresh one's.

        The obs is built once, on the merged state. ``final_obs=True`` also
        returns the terminal observation of the stepped (pre-reset) state.
        The step is ``draws`` then ``step_body``.
        """
        return self.step_body(state, actions, self.draws(dt), dt, final_obs)

    def step_body(self, state: EnvState, actions: torch.Tensor, draws: tuple,
                  dt: float = DT_DEFAULT, final_obs: bool = False, *, run=EAGER,
                  finish: Optional[Callable] = None):
        """``step`` with its random draws given (``draws``' result), each
        device segment run by ``run`` (see the module docstring);
        ``finish(new_state, *rest)``, applied inside the last segment, makes
        the result (by default ``(new_state, *rest)``)."""
        w = self._step_width(state.npc, run) if self.npc_widths else None
        cfg = self.env.config
        carries = None
        if cfg.traffic_flow and cfg.npc_mode == "exact":
            carries = self.env.exact_npc(_narrow(state, w), draws[0], dt, run, key=(w,))

        def rest(state, actions, draws, carries):
            return (finish or _result)(*self._rest(state, actions, draws, carries, w, dt,
                                                   final_obs))
        return run(("step", w, final_obs), rest, state, actions, draws, carries)

    def _rest(self, state, actions, draws, carries, w, dt, final_obs):
        """The step after the NPC width read (and the exact NPC update's
        segments, whose ``carries`` it finishes): the env's step at width
        ``w``, the auto-reset merge and the observations."""
        spawn, routes = draws
        # without auto-reset the observation is built inside the step, on the
        # narrowed pool
        small, out = self.env.step(_narrow(state, w), actions, dt,
                                   with_obs=not self.auto_reset, spawn=spawn, npc_carries=carries)
        new_state = small._replace(npc=_widen(small.npc, state.npc, w))
        if not self.auto_reset:
            return new_state, out
        ep_done = out.terminated | out.truncated                     # (B,)
        fresh = self.env.reset_state(routes)

        def pick(a, b):
            return torch.where(ep_done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        npc = new_state.npc
        if self.env.config.traffic_flow:
            npc = type(npc)(*(pick(a, b) for a, b in zip(fresh.npc, npc)))
        merged = EnvState(
            ego=type(new_state.ego)(*(pick(a, b) for a, b in zip(fresh.ego, new_state.ego))),
            lidar=pick(fresh.lidar, new_state.lidar),
            step_count=pick(fresh.step_count, new_state.step_count), npc=npc)
        # the merged pool's alive slots all lie below w: the step wrote none
        # beyond it and a fresh pool is empty
        out = out._replace(obs=self.env.observe(_narrow(merged, w)))
        if final_obs:
            return merged, out, self.env.observe(_narrow(new_state, w))
        return merged, out


def _result(*parts):
    return parts


class _GraphedStep:
    """``VectorEnv.jit_step``'s callable on the card (see there): the
    segments of ``step_body`` replayed by one ``Segments``."""

    def __init__(self, venv: VectorEnv, dt: float, donate: bool):
        self.venv, self.dt, self.donate = venv, dt, donate
        self.segments = Segments.on(venv.env.device, venv.env.npc_stats)
        self.state = self.actions = self.draws = None

    @property
    def graphs(self) -> dict:
        """The captured graphs by segment key."""
        return self.segments.graphs

    def _stage(self, state, actions, draws) -> None:
        """The step's operands written into the static buffers."""
        self.state, self.actions = stage(self.state, state), stage(self.actions, actions)
        self.draws = stage(self.draws, draws)

    def _keep(self, new_state, *rest):
        copy_tree_(self.state, new_state)
        return rest

    def __call__(self, state, actions, final_obs: bool = False):
        if profiling():
            with marked("mti.draws"):
                draws = self.venv.draws(self.dt)
            with marked("mti.stage"):
                self._stage(state, actions, draws)
        else:
            self._stage(state, actions, self.venv.draws(self.dt))
        rest = self.venv.step_body(self.state, self.actions, self.draws, self.dt, final_obs,
                                   run=self.segments, finish=self._keep)
        if self.donate:
            return (self.state, *rest)
        return (clone_tree(self.state), *clone_tree(rest))
