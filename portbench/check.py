"""Whether what the timed path produced is correct: the program's outputs
held bit for bit against the plain reference (portbench/reference/).

The configurations state the reference simulator's float32 chain: glibc's
transcendentals, IEEE divisions, correctly rounded square roots, every
product rounded before its add, and the NPCs moved and removed one at a
time in insertion order. Under that guarantee two correct implementations
agree to the bit, so every number compared is a count of values that
differ in their bits, and every limit is 0.

The reference follows the program from the program's own state: at each
checked step of the window (drawn from the seed) the recorder keeps, for the
checked env rows (drawn from the seed; the envs nearest the end of their
episode, which the step auto-resets, so that every checked step holds the
merge of fresh episodes; and with NPC traffic the busiest envs of that
step), the state the step was given and what it returned, and after the
window the reference computes that step from the same state, actions,
spawn draw and routes. The start of the chain, the reset, is
checked by itself: the reference resets the same rows from the same routes.
Each env's step depends only on its own row, so a sample of rows is a
sample of the answers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .reference import env as ref_env
from .reference import vector as ref_vector

# the numbers compared, each a count of values whose bits differ, and their limits
LIMITS = {"start": 0, "ego": 0, "lidar": 0, "npc": 0, "obs": 0, "reward": 0, "status": 0}
_STATUS_OUT = ("done", "status", "terminated", "truncated", "agents_alive", "step", "spawned")


def tree_map(fn, tree):
    """A nest of tuples and NamedTuples like ``tree`` with ``fn`` applied to
    each tensor (None stays None)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    return rebuild(tree, [tree_map(fn, t) for t in tree])


def rebuild(tree, parts: list):
    """A tuple or NamedTuple like ``tree`` holding ``parts``."""
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def take_rows(tree, rows: torch.Tensor):
    """``tree`` with every tensor's rows ``rows`` gathered (a copy, enqueued
    on the current stream)."""
    return tree_map(lambda t: t.index_select(0, rows), tree)


def clone(tree):
    return tree_map(torch.clone, tree)


def _cpu(tree):
    return tree_map(lambda t: t.to("cpu"), tree)


def _named(cls, value):
    """``value`` (a NamedTuple of the program) as the reference's ``cls``, its
    fields taken by name; fields the reference does not know are left out."""
    return cls(**{f: getattr(value, f) for f in cls._fields})


def as_reference(state):
    """The program's env state on the CPU as the reference's ``EnvState``."""
    state = _cpu(state)
    npc = state.npc
    return ref_env.EnvState(ego=_named(ref_env.EgoState, state.ego), lidar=state.lidar,
                            step_count=state.step_count,
                            npc=None if npc is None else _named(ref_env.NpcState, npc))


class Recorder:
    """Keeps, at the checked window steps, the sampled rows of the state a
    step was given, of what it returned, and which bank entries fed it.

    The rows are those drawn from the seed, the ``ending`` envs with the
    highest step counters in the step's state (those whose episode the step
    truncates, so that it merges fresh episodes into them), and, with NPC
    traffic, the ``busiest`` envs, those with the most NPCs alive, where the
    NPC loops do most of their work (a row may come twice). Each is a
    fixed number of rows chosen on the device: no read of the host."""

    def __init__(self, steps, rows: np.ndarray, busiest: int, device, ending: int = 0):
        self.steps = set(steps)
        self.rows = torch.as_tensor(rows, dtype=torch.long, device=device)
        self.busiest = busiest
        self.ending = ending
        self.taken: dict = {}
        self.full_poses = None      # the first checked step's poses, all rows
        self.pose_width = None      # the NPC width that step ran at (run.py)

    def pending(self, k: int) -> bool:
        return k in self.steps and k not in self.taken

    def before(self, k: int, state) -> None:
        if self.pending(k):
            parts = [self.rows]
            B = state.step_count.shape[0]
            if self.ending:
                parts.append(state.step_count.topk(min(self.ending, B)).indices)
            alive = state.npc.alive if state.npc is not None else None
            if self.busiest and alive is not None and alive.shape[1]:
                parts.append(alive.sum(1).topk(min(self.busiest, B)).indices)
            rows = torch.cat(parts)
            self.taken[k] = {"rows": rows, "state_in": take_rows(state, rows)}

    def after(self, k: int, state, out, entries: dict) -> None:
        rec = self.taken.get(k)
        if rec is None or "out" in rec:
            return
        rows = rec["rows"]
        rec.update(state_out=take_rows(state, rows), out=take_rows(tuple(out), rows),
                   out_fields=type(out)._fields, entries=entries)
        if self.full_poses is None:
            self.full_poses = poses(state)

    def done(self) -> bool:
        return all(k in self.taken and "out" in self.taken[k] for k in self.steps)


def poses(state) -> tuple:
    """Copies of every row's poses in ``state``: ego x, y, heading, NPC x, y,
    heading, alive (the lidar's operands, run.py)."""
    npc = state.npc
    return tuple(t.clone() for t in (state.ego.x, state.ego.y, state.ego.heading,
                                     npc.x, npc.y, npc.heading, npc.alive))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def mismatches(a, b) -> int:
    """How many values of the nests ``a`` and ``b`` differ in their bits (a
    leaf of another shape counts whole)."""
    if a is None and b is None:
        return 0
    if torch.is_tensor(a) or torch.is_tensor(b):
        if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.shape != b.shape \
                or a.dtype != b.dtype:
            return max(a.numel() if torch.is_tensor(a) else 0,
                       b.numel() if torch.is_tensor(b) else 0, 1)
        return int((_bits(a) != _bits(b)).sum())
    if len(a) != len(b):
        return max(len(a), len(b))
    return sum(mismatches(x, y) for x, y in zip(a, b))


def grouped(state, out: dict, ref_state, ref_out: dict) -> dict:
    """The numbers compared (LIMITS' keys but ``start``) of one step."""
    return {
        "ego": mismatches(state.ego, ref_state.ego),
        "lidar": mismatches(state.lidar, ref_state.lidar),
        "npc": mismatches(state.npc, ref_state.npc),
        "obs": mismatches(out.get("obs"), ref_out["obs"]),
        "reward": mismatches(out.get("reward"), ref_out["reward"]),
        "status": mismatches(state.step_count, ref_state.step_count)
        + mismatches([out.get(f) for f in _STATUS_OUT], [ref_out[f] for f in _STATUS_OUT]),
    }


def reference_env(env_config: dict) -> ref_env.IntersectionEnv:
    """The reference env of a configuration, on the CPU."""
    fields = ref_env.EnvConfig.__dataclass_fields__
    return ref_env.IntersectionEnv(ref_env.EnvConfig(
        **{k: v for k, v in env_config.items() if k in fields}))


def step_inputs(inputs, entries: dict, rows: torch.Tensor):
    """The checked rows of the bank entries that fed one step, on the CPU;
    the step's actions are the checked rows' own where the recorder kept
    them (a tensor under ``actions``), else an entry of the action bank."""
    r = rows.to("cpu")
    kept = entries["actions"]
    actions = kept.to("cpu") if torch.is_tensor(kept) else inputs.actions[kept].to("cpu")[r]
    routes = inputs.routes.entry(entries["routes"]).to("cpu")[r]
    spawn = None
    if inputs.spawns is not None:
        spawn = tuple(t.to("cpu")[r] for t in inputs.spawns.entry(entries["spawns"]))
    return actions, spawn, routes


def reference_step(ref, rec: dict, inputs, transform=None):
    """The reference's (state, out as a dict) of one recorded step;
    ``transform(state, actions) -> (state, actions)`` and
    ``transform.out(state, out)`` stand a control in the program's place."""
    actions, spawn, routes = step_inputs(inputs, rec["entries"], rec["rows"])
    state = as_reference(rec["state_in"])
    if transform is not None:
        state, actions = transform(state, actions)
    new_state, out = ref_vector.step(ref, state, actions, spawn, routes)
    if transform is not None:
        new_state, out = transform.out(new_state, out)
    return new_state, out._asdict()


def run_check(ref, recorder: Recorder, start: Optional[tuple], inputs,
              also_failed: Optional[dict] = None) -> dict:
    """The readings of a run: for each number of LIMITS, the sum over the
    checked steps (``start`` over the reset); plus ``steps``,
    ``failed_env_steps``, the checked env transitions that differ anywhere
    (with ``also_failed``, a checked step's row mask of transitions that
    another check of the entry failed, those too), and ``episode_ends``,
    the checked envs whose episode the reference ends in a checked step, so
    that the step merges a fresh one into them."""
    total = dict.fromkeys(LIMITS, 0)
    failed = ends = 0
    if start is not None:
        prog_state, prog_obs, routes0 = start
        ref_state = ref.reset_state(routes0)
        total["start"] = mismatches(as_reference(prog_state), ref_state) \
            + mismatches(prog_obs.to("cpu"), ref.observe(ref_state))
    for k in sorted(recorder.steps):
        rec = recorder.taken[k]
        state = as_reference(rec["state_out"])
        out = dict(zip(rec["out_fields"], _cpu(rec["out"])))
        ref_state, ref_out = reference_step(ref, rec, inputs)
        for name, n in grouped(state, out, ref_state, ref_out).items():
            total[name] += n
        bad = failed_mask(state, out, ref_state, ref_out)
        if also_failed is not None and k in also_failed:
            bad = also_failed[k] if bad is None else bad | also_failed[k]
        failed += int(bad.sum()) if bad is not None else 0
        ended = (ref_out["terminated"] | ref_out["truncated"]).tolist()
        ends += len({r for r, e in zip(rec["rows"].tolist(), ended) if e})
    return {**total, "steps": len(recorder.steps), "failed_env_steps": failed,
            "episode_ends": ends}


def failed_rows(state, out: dict, ref_state, ref_out: dict) -> int:
    """How many env rows of one step differ from the reference anywhere."""
    bad = failed_mask(state, out, ref_state, ref_out)
    return int(bad.sum()) if bad is not None else 0


def failed_mask(state, out: dict, ref_state, ref_out: dict) -> Optional[torch.Tensor]:
    """The env rows of one step that differ from the reference anywhere, as a
    mask (every row where a leaf's shape or type differs; None without
    leaves)."""
    bad = None
    pairs = [(state, ref_state)] + [((out.get(f),), (ref_out[f],)) for f in ref_out]
    for a, b in pairs:
        for x, y in zip(_leaves(a), _leaves(b)):
            if x.shape != y.shape or x.dtype != y.dtype:
                return torch.ones(x.shape[0] if x.dim() else 1, dtype=torch.bool)
            d = (_bits(x) != _bits(y)).reshape(x.shape[0], -1).any(1) if x.dim() \
                else (_bits(x) != _bits(y)).reshape(1)
            bad = d if bad is None else bad | d
    return bad


def _leaves(tree) -> list:
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def verdict(readings: dict) -> bool:
    """Whether every number compared is within its limit."""
    return all(readings[k] <= lim for k, lim in LIMITS.items())
