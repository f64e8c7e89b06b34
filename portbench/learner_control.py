"""The readings that set a train-step cell's limits (portbench/learner.py):
the program's, and those of the controls and planted faults put in its
place.

  python3 -m portbench.learner_control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell (run.py) at the cell's own
size, with a short window, and then, on the trajectories of its checked
train steps (the env's data, which every kind shares), the numbers the
check compares for

  * ``program``: what the program's steps produced, every number of the
    check (the lower readings);
  * each of reference/ppo.py's ``VARIANTS`` in the program's place: the
    reference learner with its parameters and Adam's moments in bfloat16
    (``bf16_master``) or its products' inputs in float8 (``fp8_forward``),
    the controls one precision below the configuration's; half of each
    minibatch's envs left out, one minibatch skipped, one permutation for
    every epoch, Adam without bias corrections, a fresh Adam at every
    step, the planted faults;
  * ``state_unchanged``: the program's outputs with its parameters and
    Adam's state left as they were (no run is needed for it).

Each of them steps from the program's state entering each checked step, as
the reference does (learner.py).

One JSON line per seed and kind. The limits lie between the program's
largest readings and the least reading that a control or a fault gives
(PERF.md).
"""
from __future__ import annotations

import argparse
import json

import torch

from . import learner, spec
from .reference.ppo import VARIANTS


def reference(ck) -> tuple:
    """The reference's rollout outputs and update chain of a run's checked steps."""
    return learner.acts(ck), learner.follow(ck)


def readings(ck, want: tuple, kind: str) -> dict:
    """The learner's numbers of ``kind`` in the program's place against
    ``want``, the reference's (``reference``)."""
    if kind == "state_unchanged":
        zeros = {k: torch.zeros_like(v) for k, v in ck.params0.items()}
        got = (learner.program_acts(ck), dict(learner.program_chain(ck), m1=zeros, change=zeros,
                                              adam=[rec["adam_in"] for rec in ck.recs]))
    else:
        got = (learner.acts(ck, kind), learner.follow(ck, kind))
    return {**learner.act_numbers(got[0], want[0]), **learner.chain_numbers(got[1], want[1])}


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
        ck = result["checked"]
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "program",
                          "readings": result["notes"]["check"]["readings"],
                          "correct": result["line"]["correct"],
                          "check_s": result["notes"]["check"]["seconds"]}), flush=True)
        want = reference(ck)
        for kind in (*VARIANTS, "state_unchanged"):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": readings(ck, want, kind)}), flush=True)
        del result, ck, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
