"""The readings that set a policy-step cell's limits (entries/policy_step.py):
the program's, and those of the controls put in its place.

  python3 -m portbench.policy_control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell (run.py) at the cell's own
size and load, with a short window, and then, on the observations that the
reference env makes of the states the run recorded at its checked steps,
the policy's numbers (``mean``, ``action``) of

  * ``program``: what the timed path produced, with every number of the
    run's check (the lower readings);
  * each of the entry's ``VARIANTS`` in the program's place: the plain
    reference with its products' inputs and weights in float8
    (``fp8_forward``, the precision below the stated bfloat16), with
    another shipped policy's weights (``other_policy``), or stepping its
    mean without the tanh (``no_tanh``);
  * ``f32_accumulate``, no control but another sound forward at the stated
    precision (entries/policy_step.py), whose readings a limit must pass;
  * the env step's controls (control.py: ``bf16``, ``torch_libm``) on the
    recorded steps.

One JSON line per seed and kind. Each control must read above a limit on
every seed; the limits lie between the program's largest readings and the
least reading that a control gives (PERF.md).
"""
from __future__ import annotations

import argparse
import json

from . import control, spec


def main(argv=None) -> int:
    from .entries import policy_step
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
        ref, rec, _, _, pol = checked = result["checked"]
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "program",
                          "readings": result["notes"]["check"]["readings"],
                          "correct": result["line"]["correct"],
                          "check_s": result["notes"]["check"]["seconds"]}), flush=True)
        obs = policy_step.reference_obs(ref, rec)
        want = policy_step.reference_outputs(pol, obs)
        for kind in (*policy_step.VARIANTS, policy_step.SOUND):
            got = policy_step.reference_outputs(pol, obs, kind)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": policy_step.numbers(got, want)}), flush=True)
        for kind in ("bf16", "torch_libm"):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": control.readings(checked, kind)}), flush=True)
        del result, checked, rec, obs, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
