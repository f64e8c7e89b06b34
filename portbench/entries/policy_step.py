"""The policy step's entry: the env step's entry (run.py's ``EnvStep``) with a
trained policy in the loop. A cell whose traffic file says
``"entry": "policy_step"`` steps the program's ``VectorEnv.jit_step()`` as
the env step's cells do, and takes each step's actions from the shipped
policy that the traffic file names (``policy``, of the family ``family``,
with the ``widths`` and the ``compute_dtype`` it states), loaded by the
program's deterministic evaluation path, ``utils/checkpoint.py::load_policy``:
the action ``tanh(mean_fn(obs))`` on the step's own observation, as the
program's ``evaluate`` drives ``VectorEnv`` with a shipped policy. The
forward runs eager, at the model's precision, the critic included, as
``mean_fn`` computes it.

Set-up is the env step's, the policy acting in the crowded steps and the
warm-up. After the window, with ``--trace 1``, ``span_steps`` more steps
record a CUDA event before and after the policy's forward (``act_ms``: the
stream's time between them, which the act_ms_per_step reader averages);
the profiled block's model FLOPs are the forward's
(``flops_per_sample`` of the family's plain reference) for every agent of
every profiled step.

How ``correct`` is decided: the env step's check (check.py), every limit 0,
the reference env stepping the checked rows from the program's state with
the actions the program stepped (the recorder keeps them for the checked
rows); and at the same checked steps the policy's, on those rows:

  * ``obs_in``: the observation the policy acted on, against the reference
    env's observation of the state the step was given (values whose bits
    differ; limit 0);
  * ``mean`` and ``action``: the program's mean and the action it stepped
    against the plain reference's (reference/policies/<family>.py, which
    reads the export itself; its dense layers at the stated precision, all
    else float32 with TF32 off, on the card where the run ran) on the
    reference's observation: the relative L2 error over the checked rows,
    the largest over the checked steps. PERF.md gives the readings that
    set the limits.

``failed`` counts the checked transitions that the env check fails, the
rows whose observation differs, and, at a checked step whose ``mean`` or
``action`` reads above its limit, the rows whose action differs in its
bits from the reference's.

``VARIANTS`` put a control in the program's place (portbench/policy_control.py):
the forward's products with their inputs and weights rounded to float8
e4m3 (``fp8_forward``, the precision below the stated bfloat16), another
shipped policy's weights (``other_policy``), the mean stepped without its
tanh (``no_tanh``). ``f32_accumulate`` is no control but another sound
forward at the stated precision: each product of the bfloat16 operands
summed by a float32 GEMM (TF32 off) and rounded to bfloat16, in another
order than the card's bfloat16 GEMM; its readings show the room that such a
forward needs under the limits.
"""
from __future__ import annotations

import dataclasses
import time
import types

import torch
from torch.nn import functional as F

from .. import check, roofline
from ..reference import ppo as ref_ppo
from ..run import EnvStep

PORT = "marl_traffic_intersection_tpu_torch"
# the traffic file's keys that belong to this entry; the rest are the env step's
KEYS = {"policy", "family", "widths", "compute_dtype", "span_steps"}
# the numbers the policy's check adds to the env step's, and their limits (PERF.md)
POLICY_LIMITS = {"obs_in": 0, "mean": 2e-3, "action": 2e-3}
VARIANTS = ("fp8_forward", "other_policy", "no_tanh")
SOUND = "f32_accumulate"
OTHER_POLICY = "policy_central_multi"


def export_path(root, name: str):
    """The shipped export ``name``'s file, which the program and the
    reference both read."""
    return root / PORT / "artifacts" / f"{name}.npz"


class HostMark:
    """A host clock's stand-in for a CUDA event (``record``, ``elapsed_time``
    in ms), for runs without a card."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostMark") -> float:
        return 1e3 * (end.t - self.t)


class Entry(EnvStep):
    """The env step with the shipped policy acting (see the module docstring)."""

    LIMITS = {**check.LIMITS, **POLICY_LIMITS}

    def __init__(self, cell, seed: int, dev, split):
        from marl_traffic_intersection_tpu_torch.utils.checkpoint import load_policy

        tr = cell.traffic
        missing = KEYS - set(tr)
        if missing:
            raise ValueError(f"traffic file: missing {sorted(missing)}")
        self.pol = pol = types.SimpleNamespace(
            family=tr["family"], kw=dict(tr["widths"]), compute_dtype=tr["compute_dtype"],
            export=export_path(cell.root, tr["policy"]),
            other=export_path(cell.root, OTHER_POLICY), device=dev)
        self.span_steps = int(tr["span_steps"])
        self.model, self.mean_fn = load_policy(tr["policy"], pol.family, dev)
        want = ref_ppo.policy(pol.family).shapes(pol.kw)
        if {k: tuple(p.shape) for k, p in self.model.named_parameters()} != want:
            raise ValueError(f"{tr['policy']}: the program's parameters are not the "
                             f"{pol.family} policy of the stated widths")
        if self.model.compute_dtype != ref_ppo.DTYPES[pol.compute_dtype]:
            raise ValueError(f"{tr['policy']}: the program computes in "
                             f"{self.model.compute_dtype}, the policy states {pol.compute_dtype}")
        self.marks, self.act_ms = None, None
        split("policy_load_s")
        super().__init__(dataclasses.replace(
            cell, traffic={k: v for k, v in tr.items() if k not in KEYS}), seed, dev, split)
        B, N = self.rows_per_step, self.env.config.num_agents
        self.step_flops = ref_ppo.policy(pol.family).flops_per_sample(pol.kw) * B * N
        self.peak_flops = roofline.PEAK_FLOPS_PER_S[pol.compute_dtype]

    def actions_of(self, obs) -> tuple:
        """The policy's (mean, action) on ``obs``."""
        mean = self.mean_fn(obs)
        return mean, torch.tanh(mean)

    def act(self, k=None) -> tuple:
        """The policy's action on the step's observation; at a checked step
        the recorder also keeps the checked rows' observation and mean, and
        the actions, which name the step's actions for the env check."""
        if self.marks is not None:
            self.marks[0].record()
        mean, actions = self.actions_of(self.obs)
        if self.marks is not None:
            self.marks[1].record()
        taken = self.rec.taken.get(k) if k is not None else None
        if taken is None or "out" in taken:
            return actions, None
        rows = taken["rows"]
        taken["policy"] = {"obs": self.obs.index_select(0, rows),
                           "mean": mean.index_select(0, rows)}
        return actions, actions.index_select(0, rows)

    def observed(self, out) -> None:
        self.obs = out.obs

    def closed(self, steps: int, trace: bool) -> None:
        """The env step's, then with a trace ``span_steps`` steps whose
        policy forward is timed."""
        super().closed(steps, trace)
        if not trace:
            return
        if self.on_card:
            pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                     for _ in range(self.span_steps)]
        else:
            pairs = [(HostMark(), HostMark()) for _ in range(self.span_steps)]
        for pair in pairs:
            self.marks = pair
            self.one()
        self.marks = None
        if self.on_card:
            torch.cuda.synchronize()
        self.act_ms = [a.elapsed_time(b) for a, b in pairs]

    def free(self) -> None:
        super().free()
        del self.model, self.mean_fn, self.obs

    def check(self) -> tuple:
        rec = self.rec
        if not rec.done():
            readings, _ = super().check()
            return {**readings, **dict.fromkeys(POLICY_LIMITS, -1)}, False
        numbers, bad = policy_check(self.ref, rec, self.pol)
        readings = check.run_check(self.ref, rec, self.start, self.inputs, also_failed=bad)
        readings.update(numbers)
        return readings, all(readings[k] <= lim for k, lim in self.LIMITS.items())

    def reader_fields(self, profile) -> dict:
        fields = dict(super().reader_fields(profile), act_ms=self.act_ms,
                      peak_flops=self.peak_flops)
        if profile is not None:
            fields["profiled_flops"] = self.step_flops * profile["steps"]
        return fields

    def trace_notes(self) -> dict:
        return {"act_ms": self.act_ms}

    def checked(self) -> tuple:
        return (*super().checked(), self.pol)


def reference_obs(ref, rec) -> dict:
    """The reference env's observation of each checked step's given state
    (its checked rows), on the CPU, by step."""
    return {k: ref.observe(check.as_reference(rec.taken[k]["state_in"]))
            for k in sorted(rec.steps)}


def program_outputs(rec) -> dict:
    """The program's (mean, stepped action) of each checked step's rows."""
    return {k: (t["policy"]["mean"].to("cpu"), t["entries"]["actions"].to("cpu"))
            for k, t in ((k, rec.taken[k]) for k in sorted(rec.steps))}


@torch.no_grad()
def reference_outputs(pol, obs: dict, variant=None) -> dict:
    """The plain reference's (mean, action) on the observations ``obs`` (by
    step), or a control's in the program's place (``VARIANTS``)."""
    if variant is not None and variant not in (*VARIANTS, SOUND):
        raise ValueError(f"unknown variant {variant!r}")
    ref_ppo.no_tf32()
    family = ref_ppo.policy(pol.family)
    params = family.load(pol.other if variant == "other_policy" else pol.export, pol.kw,
                         pol.device)
    dtype = ref_ppo.DTYPES[pol.compute_dtype]
    product = ref_ppo.product_at(dtype, fp8=variant == "fp8_forward")
    if variant == SOUND:
        def product(x, w, b):
            return F.linear(*(t.to(dtype).float() for t in (x, w, b))).to(dtype)
    out = {}
    for k, o in obs.items():
        mean = family.forward(params, o.to(pol.device), product, pol.kw)[0]
        action = mean if variant == "no_tanh" else torch.tanh(mean)
        out[k] = (mean.to("cpu"), action.to("cpu"))
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a - b‖ / ‖b‖ (float64)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def numbers(got: dict, want: dict) -> dict:
    """``mean`` and ``action`` of ``got`` against ``want`` (both by step):
    the largest relative L2 error over the steps."""
    return {name: max(_rel(got[k][i], want[k][i]) for k in want)
            for i, name in enumerate(("mean", "action"))}


def policy_check(ref, rec, pol) -> tuple:
    """The policy's numbers of a run (``obs_in``, ``mean``, ``action``), and
    by checked step the mask of its rows that the policy's check fails."""
    obs = reference_obs(ref, rec)
    got, want = program_outputs(rec), reference_outputs(pol, obs)
    out = numbers(got, want)
    out["obs_in"], bad = 0, {}
    for k, o in obs.items():
        seen = rec.taken[k]["policy"]["obs"].to("cpu")
        out["obs_in"] += check.mismatches(seen, o)
        rows = seen.shape[0]
        mask = (check._bits(seen) != check._bits(o)).reshape(rows, -1).any(1) \
            if seen.shape == o.shape else torch.ones(rows, dtype=torch.bool)
        step = numbers({k: got[k]}, {k: want[k]})
        if any(step[n] > POLICY_LIMITS[n] for n in step):
            mask = mask | (check._bits(got[k][1]) != check._bits(want[k][1])).reshape(
                rows, -1).any(1)
        bad[k] = mask
    return out, bad
