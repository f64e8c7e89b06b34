"""The readings that set the check's limits: the program's, and the
controls' that the check must fail.

  python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell (run.py) at the cell's own
size and load, with a short window, and then, on the very states, actions,
spawns and routes that the run recorded at its checked steps, the numbers
the check compares for

  * ``program``: what the timed path produced (the lower readings);
  * ``bf16``: the reference in the program's place, computed with every
    float of the state it is given, of its actions and of its results
    rounded to bfloat16, the precision below the float32 that the
    configurations state;
  * ``torch_libm``: the reference in the program's place with torch's own
    sin, cos, tan, atan2 and hypot for glibc's: it breaks the guarantee of
    the reference's float chain, the step that would tempt a later change.

One JSON line per seed and control. Each control must read above the limit
(0) on at least one number; the limits are set from these readings
(PERF.md).
"""
from __future__ import annotations

import argparse
import json

import torch

from . import check, spec
from .reference import libm


def _bf16(tree):
    """``tree`` with every float32 tensor rounded to bfloat16."""
    return check.tree_map(lambda t: t.to(torch.bfloat16).to(torch.float32)
                          if t.dtype == torch.float32 else t, tree)


class Bf16:
    """The bf16 control's rounding of what goes into and out of a step."""

    def __call__(self, state, actions):
        return _bf16(state), _bf16(actions)

    def out(self, state, out):
        return _bf16(state), _bf16(out)


def readings(checked, kind: str) -> dict:
    """The numbers compared over a run's checked steps, the program's
    (``kind="program"``) or a control's in its place."""
    ref, rec, _, inputs = checked[:4]
    if kind == "program":
        return {k: v for k, v in check.run_check(ref, rec, None, inputs).items()
                if k != "start"}
    total = {}
    for k in sorted(rec.steps):
        r = rec.taken[k]
        want_state, want_out = check.reference_step(ref, r, inputs)
        if kind == "bf16":
            got_state, got_out = check.reference_step(ref, r, inputs, transform=Bf16())
        else:
            with libm.using("torch"):
                got_state, got_out = check.reference_step(ref, r, inputs)
        for name, n in check.grouped(got_state, got_out, want_state, want_out).items():
            total[name] = total.get(name, 0) + n
    return total


def main(argv=None) -> int:
    from .run import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    for seed in args.seeds:
        result = run(cell, seed, args.seconds, False, device=args.device)
        for kind in ("program", "bf16", "torch_libm"):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": readings(result["checked"], kind),
                              "correct": result["line"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
