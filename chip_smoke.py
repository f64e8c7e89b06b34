"""Smoke test of the PyTorch port on one NVIDIA card (H100).

  python3 chip_smoke.py
  python3 chip_smoke.py --baseline DIR [DIR ...]  # also times DIR/lidar.cu, DIR/libm.cu
  python3 chip_smoke.py --phases ego_step graphs  # phases 1-5, then only these

Phases, one line each; any failure exits nonzero:
  1. device   the card's name, count, and nvidia-smi's name and power limit;
              no CUDA device -> exit 1
  2. build    every CUDA source of the port (and the CPU libm shim) built with
              nvcc/g++ in parallel, with ptxas's register and spill lines; with
              --baseline, cuobjdump's count of each libm kernel's SASS
              instructions (calls, local loads and stores, branches, divisions'
              reciprocals and checks (FCHK), f32 multiplies, f64 reciprocal
              square roots), ours and each baseline's
  3. libm     the glibc-faithful sincosf/tanf/atan2f_diff/hypotf_diff kernels
              and atan2f/hypotf (which launch the last two) on 2^22 seeded
              inputs, bit-equal to the same header built for this machine's
              CPU (decides); against this machine's glibc (shown); device
              times at (4096, 4)
              beside torch's call (sin + cos for sincosf; the subtractions and
              atan2 or hypot for the diff forms), in turns with the same
              functions of each --baseline build (its sinf + cosf pair where
              it has no sincosf, torch's subtractions and its atan2f or hypotf
              where it has no diff form); atan2f_diff and atan2f at (4096, 8)
              and hypotf_diff at (4096, 8, 160) from an interleaved path, the
              narrowed traffic shapes, the same way; the same again after
              phase 5 on the operands the main path last passed, once for each
              shape it launched (tanf: the steering angles; the strided
              kernels on the views the path passed)
  4. K1       the lidar kernel against its plain PyTorch version on the card,
              bit-equal, at the main path's 4096x4 shapes, on 36-slot fuzz
              shapes and on NaN/inf/-0.0/screen-edge poses; device times at
              4096x4 M=4 and 512x8 M=36 (and, with --baseline, those of
              other builds of lidar.cu, in turns), plain and bound times
  5. main     VectorEnv(4096 envs x 4 agents) with a seeded 256-256 bf16
              ActorCriticMLP in the loop for 200 steps, through the kernels
              (launch counters), the libm kernels (at every shape launched)
              and K1 on the last step's operands bit-equal to their plain
              versions; then 64 envs x 100
              steps on the card and on the CPU with the same resets and
              actions, bit-equal
  5b. graphs the counterpart of jax.jit (utils/graphs.py): VectorEnv.jit_step()
              against step at 4096 x 4, 200 steps in lockstep with seeded
              actions and episodes of 50 steps, state, obs, reward, status
              and done bit-equal at every step; then blocks of 200 eager and
              graphed steps in turns (zero actions): env-steps/s, device busy
              share, kernels per step, the capture time and our kernels'
              launches per replay, K1 launched 200 times in the first
              graphed block and every kernel at least once, K1 and the libm
              kernels on the graph's operands (recorded while capturing)
              bit-equal to their plain versions, each kernel's device time
              inside a replay; last, PPO at 4096 x 4, rollout 64, float32
              MLP: 2 graphed train steps (jit_train_step) against 2 eager ones
              with capturable Adam, trajectories, observations, metrics,
              parameters, Adam's moments and the final env state bit-equal,
              and the first graphed update against train's eager step (the
              host's Adam): the first rollout bit-equal, parameters within
              1e-5 and Adam's moments within 1e-4 of their largest, the
              update moving the parameters more than ten times that;
              rollout_s and update_s of each and the busy share of a third
              update, the graphs' capture times and launches per replay
  6. train    the train entry point (PPO) at 4096 x 4, rollout 64, 4 epochs x
              4 minibatches, bf16 MLP: 3 updates with a checkpoint, then one
              more by auto-resume; finite losses, 48 optimizer steps, K1
              launched 64 x 3 times and every kernel at least once (launch
              counters), each on its last operands at each shape bit-equal
              to its plain version; env-steps/s, the rollout/update split and peak
              memory; then the same entry point at the same size for 4
              updates each of the MLP with --norm-reward, conv, central and
              attention: finite losses, K1 launched 64 x 4 times, the split,
              peak memory; each run's last update profiled (device busy
              share, launches, top kernels; Chrome traces in chiprun_out/);
              last, one update of a fixed 64 x 4 x 16 CPU trajectory on the
              card and on the CPU in float32, parameters within 1e-5 and
              Adam's moments within 1e-4 of their largest, the update moving
              the parameters more than ten times that
  6b. npc_move  K2, the NPC planner's move (csrc/npc_move.cu), against its
              plain version core/npc.py::move_ref on the card and on the CPU,
              bit for bit, one launch a call: on ops/npc_move_cases.py's
              cases at 256 envs (dense and slot at w = 8, 16, 32; the edge
              cases), then on the arguments the traffic path last passed at
              each (S, M) in 10 eager config-4 steps at 4096 x 8 after 100,
              narrowed (npc_tier -1), at npc_tier 16 and at the full width:
              dense at w = 8, 16 and 32 and the slot rounds; at each, K2's
              device time beside move_ref's device time and launches on the
              card and its time on the CPU, and the bound from bytes and
              operations; ptxas's registers and spills. Last, 40 graphed
              config-4 steps (jit_step) after 50: K2's launches in each step
              equal 1 + that step's cleanup rounds
  6c. ego_step  K3, the ego tick (csrc/ego_step.cu), against its plain
              version core/env.py::ego_step_ref on the card (NaNs as NaNs),
              one launch a call: on ops/ego_step_cases.py's cases at 64 envs
              and at 4096 x 4 (w = 0) and 4096 x 8 (w = 8, 16); then on the
              arguments the main path last passed in 10 eager steps after 100
              at 4096 x 4 without NPCs and at 4096 x 8 among NPCs (npc_tier
              -1 and 16: w = 8 and 16): K3's device time beside
              ego_step_ref's device time and launches on the card, and the
              bound from bytes; ptxas's registers and spills. Last, 40
              graphed config-4 steps: one K3 launch in each
  7. traffic  BASELINE config 4 (8 agents, density 1.0, 32 NPC slots, exact
              NPC mode) at 4096 envs for 200 steps with the bf16 MLP in the
              loop, spawns drawn on the card, four times in turns: the pool
              narrowed to its live slot prefix (npc_tier=-1, the default),
              the full width (npc_tier=0), then the full width and narrowed
              for 50 steps; the same resets, spawns and actions each time,
              and the final states of each pair bit-equal. Each: finite obs,
              NPCs spawned, K1 launched once per step at M = 8 + w for the
              widths w that ran (M = 40 at the full width) and every kernel
              at least once; env-steps/s, the widths run, launches and
              device reads per step, the NPC loops' rounds, alive slots per
              env (batch max and mean), peak memory, and every libm kernel
              on the last step's operands, at each shape it launched at,
              bit-equal to its CPU build (the first run also times the diff
              forms and hypotf on them); the first two also a
              profile (busy share, top kernels) and the device time of the
              NPC update and of its dense plan at the width most steps ran.
              Then 100 steps in the fast NPC mode (with a profile) and 50
              exact steps at density 10 (test.py's traffic) after 150
              warm-up steps, narrowed, each with the same line. K1 on the
              last obstacle set of every M of every one of these runs (40
              full, 16 and 24 narrowed) bit-equal to the plain version, and
              timed at each M. Then the graphed step (jit_step: the
              step's segments replayed as CUDA graphs, the host reading the
              NPC width and steering the exact mode's loops between them)
              against the eager one, for exact narrowed, exact full width,
              fast narrowed and exact density 10 (after 150 warm-up steps):
              the graphed warm-up steps with the captures, K1 and every libm
              kernel on the operands recorded while capturing bit-equal to
              their plain versions, 30 lockstep steps bit-equal at every step
              (state, obs, reward, status, done, flags) with equal npc_stats,
              then 40-step blocks in turns (eager, graphed, graphed, eager;
              each pair's npc_stats equal), a profile of 5 steps of each and
              the final states bit-equal: env-steps/s, device ms, busy share
              and launches per step, host reads and loop rounds per step,
              our kernels per step, the graphs and their capture time, peak
              memory. 64
              envs x 8 agents x 200 steps at the full NPC width with a spawn
              try every step and resets at step 175: the card run bit-equal
              to the CPU run, and on the card the exact mode's slot and wave
              schedules, whose cleanup replays and collision cascade must
              both have run, bit-equal to the serial transcription. Last,
              the train entry point with --traffic --density 1.0 at 4096 x
              4: 3 updates and one more by auto-resume, finite losses, the
              kernels launched on their last operands at each shape
              bit-equal to their plain versions, every update logged
              "step": "graphed"; last, PPO with traffic at 4096 x 4,
              rollout 64: the graphed train step's first rollout bit-equal
              to train's eager step's, the split and busy share of each
  8. policies the twelve shipped policies (the committed numpy exports) loaded
              onto the card; each family's forward on 4096 seeded observations
              on the card and on the CPU within the CPU tests' bf16
              tolerances; the GRUs over 16 steps of 6 seeded sequences, their
              hidden states within GRU_H_BF16 (set from readings), and in
              float32 means and hidden states within 1e-5; evaluate --config
              1 --vector 1024 --max-steps 200 with each *_cfg1 policy (mlp,
              attention, conv, gru, sac): success rate 1.0 and no crash, mean
              episode length beside README's, K1 (1024x1 M=1) and the libm
              kernels on the last step's operands bit-equal to their plain
              versions; evaluate --config 4 --vector 4096 --max-steps
              200 with policy_attn_multi, policy_gru_multi, policy_central_cfg4
              and policy_sac_multi: finite rewards, K1 launched once per step
              at M = 8 + w (w the NPC pool's width: 8, 16 or 32), K1 on the
              last obstacle set of each M and every libm kernel launched on
              its last operands at each shape bit-equal to their plain versions,
              completions, crashes and env-steps/s; serve with
              policy_mlp_multi and policy_gru_multi on a free local port, 3
              requests each (1 row, 300 rows, and a third of 256 rows or a GRU
              round trip with h), every answer bit-equal to a direct padded
              forward on the card, latency per request
  9. learners train --model gru at 4096 x 4, rollout 64: 3 updates with a
              checkpoint, then one more by auto-resume (profiled): finite
              losses, K1 launched 64 x 3 times, the split and peak memory;
              train_sac at its defaults (256 x 2) for 40 calls with --demo
              artifacts/policy_mlp_multi --demo-steps 16: the ring holding the
              demo's transitions, updates begun, finite losses, K1 once per
              env step, K1 (256x2 M=2) and the libm kernels on the last
              step's operands bit-equal to their plain versions; train_sac
              at 4096 x 4 for 8 calls: env-steps/s, peak
              memory; one recurrent-PPO update and 8 SAC updates of fixed
              64 x 4 x 16 CPU trajectories on the card and on the CPU in
              float32 (injected permutations, indices and noise): parameters
              within 1e-5 and Adam's moments within 1e-4 of their largest
 10. resume   the fine-tune that made policy_attn_multi, train --model attention
              --resume policy_attn_cfg1 --agents 4 --ent-coef 0.001 --lr 1e-4
              --updates 2 at train's default width (1024 x 4, rollout 64): the
              first update is the store's and Adam resumes at the store's step
              count, the minibatch counter from 0, finite losses, K1 launched 64
              x 2 times and every kernel at least once; the split, env-steps/s and
              peak memory; warm_start_central from policy_mlp_cfg1, then train
              --model central --resume DIR --critic-warmup 1 --updates 2 (the
              actor held on the first update); one float32 update resumed from
              policy_mlp_cfg1 on a fixed 64 x 1 x 16 config-1 CPU trajectory on
              the card and on the CPU, parameters within 1e-5 and Adam's moments
              within 1e-4 of their largest
 11. gym      GymIntersectionEnv on config 1, 200 steps of seeded random actions
              (reset when an episode ends) on the card and on the CPU: obs,
              rewards, done and status bit-equal, K1 once per step at 1x1 M=1,
              every kernel launched, K1 and the libm kernels on the last step's
              operands bit-equal to their plain versions; the median wall ms per
              step on the card, on the CPU and with backend="native" (2000
              steps); evaluate --config 1 --episodes 3 with --policy scripted and
              with policy_mlp_cfg1 on the card, every episode a success; 200
              steps of config 2 (traffic), finite, K1 once per step at M=33,
              K1 and every libm kernel launched bit-equal to their plain
              versions on the last step's operands, at each shape
 12. planning snapshot planning (algos/mcts.py) on config 1's left turn, closed
              loop for 5 planned steps each: random shooting (mpc_policy, 256
              candidates, horizon 20) and CEM (cem_policy, 64 candidates, 4
              iterations, horizon 20); ms per planned step, K1 launched 20
              (80) times per plan at 256x1 (64x1) M=1, K1 and the libm
              kernels on the last plan's operands bit-equal to their plain
              versions; then one plan of each on the card and on the CPU with
              the same injected draws: random shooting's best action and
              return bit-equal, CEM's mean and first action within CEM_TOL
 13. distributed  multi-process training (parallel/mesh.py): train
              --distributed under torchrun --nproc_per_node 1 (NCCL, world
              1) at 4096 x 4, rollout 64, bf16 MLP, 6 updates (the last
              profiled), then the same command in one process (each a child
              process running this script with --train-child): finite
              losses, 96 optimizer steps,
              K1 launched 64 x 6 times and every libm kernel at least once
              (the child's launch counters), each on its last operands at
              each shape bit-equal to its plain version, and no
              torch.distributed collective in any update (the child's
              census: none runs over an axis of one rank); env-steps/s and
              the median and range of the rollout/update split of updates
              1-4 of each run, and the device busy share, launches and top
              kernels of its last; one float32
              update of a
              fixed 64 x 4 x 16 CPU trajectory through the distributed
              learner at world 1 (NCCL, in this process) and the plain
              learner on the card, parameters within DIST_PARAM_TOL and
              Adam's moments within DIST_MOMENT_TOL of their largest;
              dryrun_multichip(1, "cuda") (every family's sharded train step
              over NCCL, and the traffic families); dryrun_multichip(2,
              "cuda", backend="gloo"), two ranks on the one card at dp 2 and
              tp 2; last, the bench's JSON line at BENCH_REPEATS=2 (4096 x 4):
              vs_baseline over the pinned reference rate, 3004.4
Then one JSON line of every kernel's numbers, the card line, and last the
result line {"ok": true, "device": {...}}.

Kernel times ("ms") are device times per launch: torch.profiler's self
device time of the kernel over many launches. "event_ms" is the CUDA-event
time of back-to-back calls of the wrapper, which includes the host's
dispatch whenever a launch is shorter than the wrapper's Python call.
"launch_floor_ms" (libm rows) is the device time of the smallest launch, a
torch.add of two 1-element tensors; a libm row's "ms" and "library_ms" are
at (4096, 4) on uniform operands, "baselines" holds the --baseline builds'
times there, "main_path" the same times on the operands the main path
last passed, one entry for each shape it launched, "traffic_shapes" those at
phase 3's narrowed traffic shapes and "traffic_path" those on the first
narrowed traffic run's last operands. atan2f and hypotf launch the kernels
of atan2f_diff and hypotf_diff (on signed-zero operands that make the
subtractions exact), so their numbers are in those rows, under "atan2f"
and "hypotf" and as the "function" of a shape's entry, and their launches
in those rows' counts. "launches" counts the main
phase's launches, "launches_graphed" those of phase 5b's first block of
200 graphed steps, "launches_per_replay" a graphed step's launches of the
kernel per replay and "ms_in_replay" its device time per launch inside
the replays, "launches_train" those of the train phase's 3 updates,
"launches_traffic" those of the traffic phase's 200 narrowed exact steps,
"launches_eval_config4" those of 200 config-4 evaluate steps with the GRU
policy, "launches_gru_train" those of the 3 GRU updates at 4096 x 4 (and
their reset's observation), "launches_sac_train" those of train_sac at
256 x 2: 16 demo steps, then 40 calls of 8 env steps and updates,
"launches_resume" those of the 2 resumed attention updates at 1024 x 4,
"launches_gym" those of the 200 config-1 gym steps on the card,
"launches_traffic_full" those of the 200 exact steps at the full NPC width
("launches_traffic" are the narrowed run's), "launches_traffic_graphed"
those of 40 graphed exact narrowed traffic steps and
"ms_in_traffic_replay" the kernel's device time per launch inside 5 such
replayed steps, and "launches_plan_mpc" and
"launches_plan_cem" those of one random-shooting and one CEM plan,
"launches_distributed" those of the first train --distributed run's 6
updates at 4096 x 4. K1's
"launches_traffic_by_m" and "launches_traffic_density10_by_m" count the
narrowed run's launches at density 1 and 10 by obstacle count M, and its
"*_traffic" keys hold its numbers at M = 40, "*_traffic_m<M>" at the
narrowed M.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM float64 outside the tensor cores
SRC = "marl_traffic_intersection_tpu_torch/csrc/"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, match=None, tries=5, per_call=1):
    """Mean device milliseconds per call of ``fn`` in the kernels whose name
    contains ``match`` (all kernels if None), from the self device time
    torch.profiler records over ``reps`` calls, each making ``per_call``
    launches. The profiler now and then loses a window's kernel records; such
    a window is profiled again, and after ``tries`` the mean is over the
    launches kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and (match is None or match in e.key)]
        got = (sum(e.count for e in evs),
               sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                   for e in evs))
        best = max(best, got)
        if got[0] == reps * per_call:
            break
        phase("timing", f"the profiler recorded {got[0]} launches of {match!r} in {reps} calls")
    launches, us = best
    if not launches or us <= 0:
        raise RuntimeError(f"the profiler recorded no device time for {match!r}")
    return us / 1e3 / launches * per_call


SASS_OPS = ("CALL", "LDL", "STL", "BRA", "BSSY", "MUFU.RCP", "MUFU.RSQ64H", "FCHK", "FMUL",
            "DFMA", "DMUL", "DADD", "F2F", "F2I", "I2F")


def sass_counts(so) -> dict:
    """cuobjdump's SASS of the library ``so``: for each kernel (mangled name),
    its instruction count and the count of each opcode of SASS_OPS (a
    prefix: "F2F" counts every F2F.*). Code that a kernel calls is counted
    in it. Empty if cuobjdump is missing or fails."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([exe, "-sass", str(so)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    out, cur = {}, None
    for ln in text.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            cur = out.setdefault(m.group(1), collections.Counter())
        elif cur is not None and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)):
            op = m.group(1)
            cur["instructions"] += 1
            for k in SASS_OPS:
                if op == k or op.startswith(k + ".") or ("." in k and op.startswith(k)):
                    cur[k] += 1
    return {k: dict(v) for k, v in out.items()}


def outputs(r) -> tuple:
    return r if isinstance(r, tuple) else (r,)


def sin_cos(t):
    return torch.sin(t), torch.cos(t)


def atan2_diff(ay, by, ax, bx):
    return torch.atan2(-(ay - by), ax - bx)


def hypot_diff(ax, bx, ay, by):
    return torch.hypot(ax - bx, ay - by)


# libm function: operations per element (f64, and the diff forms' f32
# subtractions), torch's call for the same function (not glibc-exact) and its
# launches, the function of the JAX package it replaces, the functor's name
# in the mangled names of its kernel in libm.cu (every instantiation of a
# strided one; atan2f and hypotf launch the diff kernels)
LibmSpec = collections.namedtuple("LibmSpec", "ops lib_fn lib_launches replaces key")
LIBM = {
    "sincosf": LibmSpec(28, sin_cos, 2,
                        "marl_traffic_intersection_tpu/ops/exact_trig.py:145, :162",
                        "sincosf_kernel"),
    "tanf": LibmSpec(40, torch.tan, 1, "marl_traffic_intersection_tpu/ops/exact_trig.py:299",
                     "TanF"),
    "atan2f": LibmSpec(40, torch.atan2, 1,
                       "marl_traffic_intersection_tpu/ops/exact_libm.py:279", "10Atan2FDiffE"),
    "hypotf": LibmSpec(6, torch.hypot, 1,
                       "marl_traffic_intersection_tpu/ops/exact_libm.py:188", "10HypotFDiffE"),
    "atan2f_diff": LibmSpec(42, atan2_diff, 4,
                            "marl_traffic_intersection_tpu/ops/exact_libm.py:279",
                            "10Atan2FDiffE"),
    "hypotf_diff": LibmSpec(8, hypot_diff, 3,
                            "marl_traffic_intersection_tpu/ops/exact_libm.py:188",
                            "10HypotFDiffE"),
}
# the --baseline builds of libm.cu: directory -> baseline_libm's functions
LIBM_BASES: dict = {}
def stored(t) -> int:
    """The elements a view reads: its size over the dimensions it is not
    broadcast along."""
    return int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0]))


def baseline_libm(so) -> dict:
    """The functions of another build of libm.cu (``so``): name -> (a call on
    float32 tensors on the card, launches per call given its operands).
    A build with the diff forms is launched as ours is (ops/libm.launch).
    An older one takes contiguous operands of one shape, so each operand
    that is not is copied first (a launch, as that build's wrapper did); its
    sinf and cosf stand for a missing sincosf, and the torch subtractions
    and its atan2f or hypotf for a missing diff form."""
    from marl_traffic_intersection_tpu_torch.ops import libm, native

    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "libm_hypotf_diff"):
        libm.type_cuda(lib)

        def launched(name):
            def call(*xs):
                outs = libm.launch(lib, name, xs)
                return outs[0] if len(outs) == 1 else tuple(outs)
            return call, lambda *xs: 1
        return {name: launched(name) for name in (*libm.CUDA_KERNELS, *libm.KERNEL_OF)}
    fns = {}
    for name, (nin, nout) in libm.ARITY.items():
        f = getattr(lib, "libm_" + name, None)
        if f is None:
            continue
        f.argtypes = [ctypes.c_void_p] * (nin + nout) + [ctypes.c_long, ctypes.c_void_p]
        f.restype = ctypes.c_int

        def call(*xs, f=f, nout=nout, name=name):
            xs = [t.contiguous() for t in torch.broadcast_tensors(*xs)]
            outs = [torch.empty_like(xs[0]) for _ in range(nout)]
            rc = f(*map(native.ptr, (*xs, *outs)), outs[0].numel(), native.stream_of(outs[0]))
            native.check(rc, lib, f"baseline {name}")
            return outs[0] if nout == 1 else tuple(outs)
        fns[name] = (call, lambda *xs: 1 + sum(not t.is_contiguous()
                                               for t in torch.broadcast_tensors(*xs)))
    if "sincosf" not in fns and {"sinf", "cosf"} <= set(fns):
        fns["sincosf"] = (lambda t: (fns["sinf"][0](t), fns["cosf"][0](t)), lambda t: 2)
    for name, (base, form) in libm.DIFF.items():
        if name not in fns and base in fns:
            # the subtractions (and atan2f's negation) give contiguous operands
            fns[name] = (lambda *xs, f=fns[base][0], form=form: f(*form(*xs)),
                         lambda *xs, name=name: LIBM[name].lib_launches)
    return fns


def libm_times(name, args, bases) -> dict:
    """libm kernel ``name`` on ``args`` (float32 tensors on the card, views
    as a path passes them) in turns (a, b, c, c, b, a) with torch's call and
    with the same function of each baseline build (``bases``: directory ->
    baseline_libm's functions, each first held bit for bit against ours):
    device ms per call, each the mean of two turns, and the bound for these
    operands (each element a view reads, read once; the outputs written)."""
    from marl_traffic_intersection_tpu_torch.ops import libm

    spec = LIBM[name]
    ours = getattr(libm, name)
    variants = {"libm.cu": (lambda: ours(*args), 1),
                "torch": (lambda: spec.lib_fn(*args), spec.lib_launches)}
    want = outputs(ours(*args))
    for d, fns in bases.items():
        if name in fns:
            fn, k = fns[name]
            if not all(bits_equal(a, b) for a, b in zip(outputs(fn(*args)), want)):
                raise RuntimeError(f"the baseline {d}'s {name} differs from libm.cu's")
            variants[d] = (lambda fn=fn: fn(*args), k(*args))
    times = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        fn, k = variants[v]
        times[v].append(device_ms(fn, 200, per_call=k))
    ms = {v: sum(t) / len(t) for v, t in times.items()}
    n = want[0].numel()
    nbytes = 4 * (sum(stored(a) for a in args) + n * len(want))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, n * spec.ops / F64_OPS_PER_S
    out = dict(ms=ms["libm.cu"], library_ms=ms["torch"], bound_ms=1e3 * max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    base = {v: dict(ms=t, launches_per_call=variants[v][1]) for v, t in ms.items()
            if v not in ("libm.cu", "torch")}
    if base:
        out["baselines"] = base
    return out


def per_variant(times) -> dict:
    """libm_times' device ms by variant, for a phase line."""
    return {"libm.cu": round(times["ms"], 7), "torch": round(times["library_ms"], 7),
            **{d: round(b["ms"], 7) for d, b in times.get("baselines", {}).items()}}


def ptxas_info(log):
    """Per compiled entry (mangled name): registers, stack and spill bytes,
    from nvcc's -Xptxas -v output."""
    info, entry, props = {}, None, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", ln):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", ln):
            info.setdefault(props, {}).update(stack_bytes=int(m.group(1)),
                                              spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            info.setdefault(entry, {})["registers"] = int(m.group(1))
    return info


def kernel_regs(info, key):
    """The ptxas numbers of the entries whose mangled names contain ``key``
    (a strided libm kernel has one per dimension count): the largest of
    each."""
    hits = [v for k, v in info.items() if key in k and "registers" in v]
    if not hits:
        raise RuntimeError(f"ptxas output: no entry matches {key!r}")
    return {k: max((h.get(k) or 0) for h in hits)
            for k in ("registers", "stack_bytes", "spill_stores", "spill_loads")}


def host_ms(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def main() -> int:
    if sys.argv[1:2] == ["--train-child"]:          # the distributed phase's child
        return train_child(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="DIR", nargs="+", default=[],
                    help="directories each holding another lidar.cu and libm.cu (and the "
                         "headers they include), e.g. csrc/ of an earlier commit; each kernel "
                         "is checked and timed in turns with this one's")
    ap.add_argument("--phases", metavar="NAME", nargs="+", default=None,
                    help="run only these of the phases after main (graphs, train, npc_move, "
                         "ego_step, traffic, policies, learners, resume, gym, planning, "
                         "distributed)")
    opts = ap.parse_args()

    # ---- 1. device
    if not torch.cuda.is_available():
        phase("device", "FAIL: torch.cuda.is_available() is false")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase("device", f"{kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} "
                    f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---- 2. build (nothing is built ahead of time; all sources at once)
    from marl_traffic_intersection_tpu_torch.ops import native
    t0 = time.perf_counter()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    native.BUILD.mkdir(parents=True, exist_ok=True)

    def start_baseline(source, j, d):
        so = native.BUILD / f"{source.split('.')[0]}-baseline-{j}.so"
        return so, subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, os.path.join(d, source), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # other lidar.cu and libm.cu files, built beside ours with the same flags
    baselines = {d: start_baseline("lidar.cu", j, d) for j, d in enumerate(opts.baseline)}
    libm_built = {d: start_baseline("libm.cu", j, d) for j, d in enumerate(opts.baseline)}
    sources = ["libm.cu", "lidar.cu", "npc_move.cu", "ego_step.cu", "libm_host.cpp"]
    started = [(s, native.start_build(s)) for s in sources]
    for s, st in started:
        native.finish_build(s, st)
    ptxas = {}
    for s in sources:
        secs, log = native.BUILD_SECONDS.get(s, 0.0), native.build_log(s)
        ptxas.update(ptxas_info(log))
        keep = [ln.strip() for ln in log.splitlines()
                if re.search(r"registers|spill|bytes stack", ln)]
        phase("build", f"{s}: {secs:.1f} s; " + " | ".join(keep))
    for d, (so, proc) in baselines.items():
        log = proc.communicate()[0]
        if proc.returncode:
            phase("build", f"FAIL: the baseline {d}/lidar.cu:\n{log}")
            return 1
        baselines[d] = (so, kernel_regs(ptxas_info(log), "lidar_kernel"))
        phase("build", f"baseline {d}/lidar.cu: {baselines[d][1]}")
    if opts.baseline:
        sass = sass_counts(native.library_path("libm.cu"))
        phase("build", f"libm.cu SASS by kernel: {sass or 'cuobjdump gave nothing'}")
    for d, (so, proc) in libm_built.items():
        log = proc.communicate()[0]
        if proc.returncode:
            phase("build", f"FAIL: the baseline {d}/libm.cu:\n{log}")
            return 1
        LIBM_BASES[d] = baseline_libm(so)
        phase("build", f"baseline {d}/libm.cu: {sorted(LIBM_BASES[d])}; "
                       f"ptxas {ptxas_info(log)}; SASS by kernel {sass_counts(so)}")
    phase("build", f"all built in {time.perf_counter() - t0:.1f} s")

    from marl_traffic_intersection_tpu_torch import (ActorCriticMLP, EnvConfig,
                                                     IntersectionEnv, VectorEnv)
    from marl_traffic_intersection_tpu_torch.core.lidar import REL_ANGLES, lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.core.routes import default_ego_routes
    from marl_traffic_intersection_tpu_torch.ops import libm, lidar_cuda
    from marl_traffic_intersection_tpu_torch.ops.lidar_cases import edge_inputs, fuzz_inputs
    from marl_traffic_intersection_tpu_torch.ops.lidar_cuda import lidar_scan
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    kernels = {}

    # ---- 3. libm
    rng = np.random.RandomState(0)
    axis = np.asarray([0.0, -0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 2 * np.pi,
                       -2 * np.pi, np.pi / 4], np.float32)
    x = np.concatenate([rng.uniform(-7, 7, 1 << 22).astype(np.float32), axis])
    y = np.concatenate([rng.uniform(-7, 7, 1 << 22).astype(np.float32), axis[::-1]])
    # screen coordinates for the diff forms (a pose and a point of each axis),
    # some pairs equal: the signed zero of -(a - a)
    scr = rng.uniform(-100, 1100, (4, x.size)).astype(np.float32)
    scr[1, ::4], scr[3, 1::3] = scr[0, ::4], scr[2, 1::3]
    # each kernel's row before the functions that launch it
    uniform = {"sincosf": (x,), "tanf": (x,), "atan2f_diff": tuple(scr),
               "hypotf_diff": tuple(scr), "atan2f": (y, x), "hypotf": (x * 100, y * 100)}
    drawn = {"sincosf": "uniform(-7, 7)", "tanf": "uniform(-7, 7)", "atan2f": "uniform(-7, 7)",
             "hypotf": "uniform(-700, 700)", "atan2f_diff": "uniform(-100, 1100)",
             "hypotf_diff": "uniform(-100, 1100)"}
    glibc = os.confstr("CS_GNU_LIBC_VERSION")
    one = torch.ones(1, device=dev)
    floor_ms = device_ms(lambda: torch.add(one, one), 200)
    phase("libm", f"launch floor: torch.add of two 1-element tensors, device {floor_ms:.7f} ms; "
                  f"card {card}")
    bshape = (4096, 4)    # the env's (B, N) at the main path
    for name, args in uniform.items():
        key = LIBM[name].key
        fn = getattr(libm, name)
        got = outputs(fn(*[torch.from_numpy(a).to(dev) for a in args]))
        want = outputs(libm.transcribed_np(name, *args))
        glib = outputs(libm.glibc_np(name, *args))
        n_diff = sum(int((g.cpu().numpy().view(np.int32) != w.view(np.int32)).sum())
                     for g, w in zip(got, want))
        n_glibc = sum(int((g.cpu().numpy().view(np.int32) != w.view(np.int32)).sum())
                      for g, w in zip(got, glib))
        if n_diff:
            phase("libm", f"FAIL {name}: {n_diff} of {got[0].numel() * len(got)} results differ "
                          f"from the CPU build")
            return 1
        small = [torch.from_numpy(a[:bshape[0] * bshape[1]].reshape(bshape)).to(dev)
                 for a in args]
        small_cpu = [t.cpu() for t in small]
        row = dict(max_abs_err=max(float(np.abs(g.cpu().numpy().astype(np.float64) - w).max())
                                   for g, w in zip(got, want)),
                   event_ms=cuda_ms(lambda: fn(*small), 200),
                   plain_ms=host_ms(lambda: fn(*small_cpu), 20))
        times = libm_times(name, small, LIBM_BASES)
        row.update(times)
        kernel = libm.KERNEL_OF.get(name, name)
        if kernel == name:
            kernels[name] = dict(name=name, route="cuda", source=SRC + "libm.cu",
                                 replaces=LIBM[name].replaces, **row,
                                 launch_floor_ms=floor_ms, **kernel_regs(ptxas, key))
        else:       # a function this kernel launches: its numbers in the row
            kernels[kernel][name] = row
        k = kernels[kernel]
        phase("libm", f"{name}: bit-equal to the CPU build on {got[0].numel()} inputs; "
                      f"{n_glibc} results differ from this machine's {glibc} (shown only); at "
                      f"{bshape}, {drawn[name]}: {per_variant(times)}; bound "
                      f"{times['bound_ms']:.7f} ms; events, with the host: "
                      f"{row['event_ms']:.4f} ms; torch's call is not glibc-exact; "
                      f"{kernel}'s {k['registers']} registers, {k['stack_bytes']} B stack; "
                      f"card {card}")

    # the narrowed traffic shapes (w = 8 NPC slots): the plan's heading error
    # toward its lookahead point, (4096, 8), and its distances from each
    # planner to every point of its path, (4096, 8, 160), read in place from
    # an interleaved (4096, 8, 160, 2) path (a build without the diff forms
    # subtracts first)
    pose = torch.from_numpy(rng.uniform(-100, 1100, (4, 4096, 8)).astype(np.float32)).to(dev)
    path = torch.from_numpy(rng.uniform(-100, 1100, (4096, 8, 160, 2)).astype(np.float32)).to(dev)
    for name, args in (("atan2f_diff", tuple(pose)),
                       ("atan2f", (-(pose[0] - pose[1]), pose[2] - pose[3])),
                       ("hypotf_diff", (path[..., 0], pose[0, ..., None], path[..., 1],
                                        pose[1, ..., None]))):
        got, want = getattr(libm, name)(*args), getattr(libm, name)(*(a.cpu() for a in args))
        if not bits_equal(got, want):
            phase("libm", f"FAIL {name}: differs from its CPU build at {tuple(got.shape)}")
            return 1
        times = libm_times(name, list(args), LIBM_BASES)
        kernels[libm.KERNEL_OF.get(name, name)].setdefault("traffic_shapes", []).append(
            dict(function=name, shape=list(got.shape), **times))
        phase("libm", f"{name} at the narrowed traffic shape {tuple(got.shape)}: bit-equal "
                      f"to the CPU build; device ms per call {per_variant(times)}; bound "
                      f"{times['bound_ms']:.7f} ms ({times['bound_by']}); card {card}")
    del pose, path

    # ---- 4. K1
    def on_card(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    # main-path shapes and poses: the egos of a VectorEnv after a few steps
    env = IntersectionEnv(EnvConfig(num_agents=4, max_steps=10 ** 9), device=dev)
    venv = VectorEnv(env, num_envs=4096, seed=1)
    st, _ = venv.reset()
    for _ in range(30):
        st, _ = venv.step(st, torch.full((4096, 4, 2), 0.5, device=dev))
    e = st.ego
    main_args = [e.x, e.y, e.heading, e.x, e.y, e.heading,
                 torch.ones_like(e.alive)]
    cases = {"main 4096x4 M=4": main_args,
             "random 2048x1 M=36": on_card(fuzz_inputs(2, 2048, 1, 36)),
             "axis-aligned 2048x1 M=36": on_card(fuzz_inputs(3, 2048, 1, 36, axis_aligned=True)),
             "lattice 2048x1 M=36": on_card(fuzz_inputs(4, 2048, 1, 36, True, True)),
             "env 512x8 M=36": on_card(fuzz_inputs(5, 512, 8, 36)),
             "edges 1536x2 M=12": on_card(edge_inputs())}
    for label, args in cases.items():
        got = lidar_scan(*args)
        ref, samples = lidar_scan_ref(*args, return_samples=True)
        torch.cuda.synchronize()
        if not bits_equal(got, ref):
            diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            phase("K1", f"FAIL {label}: {diff} rays differ from lidar_scan_ref")
            return 1
        phase("K1", f"{label}: bit-equal to the plain version "
                    f"({got.numel()} rays, {int(samples.sum())} samples marched)")

    def baseline_scan(so):
        """A wrapper of another build of lidar.cu with the same launcher."""
        lib = ctypes.CDLL(str(so))
        lib.lidar_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.lidar_scan_launch.restype = ctypes.c_int

        def scan(sx, sy, sh, ox, oy, oh, om):
            out = torch.empty((*sx.shape, 96), dtype=torch.float32, device=dev)
            rc = lib.lidar_scan_launch(
                *map(native.ptr, (sx, sy, sh, ox, oy, oh, om, libm.table(REL_ANGLES, dev), out)),
                *sx.shape, ox.shape[1], 3, native.stream_of(out))
            native.check(rc, lib, "baseline lidar_scan")
            return out
        return scan

    timed = {"4096x4 M=4": main_args, "512x8 M=36": cases["env 512x8 M=36"]}
    rows = {}
    for label, args in timed.items():
        (B, N), M = args[0].shape, args[3].shape[1]
        ref, samples = lidar_scan_ref(*args, return_samples=True)
        bound, bound_by = k1_bound(B, N, M, samples)
        variants = {"lidar.cu": lambda: lidar_scan(*args)}
        for d, (so, _) in baselines.items():
            scan = baseline_scan(so)
            if not bits_equal(scan(*args), ref):
                phase("K1", f"FAIL: the baseline {d} differs from the plain version at {label}")
                return 1
            variants[d] = lambda scan=scan: scan(*args)
        # a warp is 32 adjacent rays of one agent and runs as long as its
        # longest ray: the share of its lanes' sample steps that do work
        warps = samples.reshape(-1, 32).double()
        lanes = float(warps.sum() / (32 * warps.max(1).values).sum())
        times = {v: [] for v in variants}
        for v in list(variants) + list(variants)[::-1]:     # in turns: a, b, c, c, b, a
            times[v].append(device_ms(variants[v], 50, "lidar_kernel"))
        rows[label] = dict(
            ms={v: sum(t) / len(t) for v, t in times.items()},
            bound_ms=bound, bound_by=bound_by, blocks_per_sm=lidar_cuda.blocks_per_sm(M),
            lane_efficiency=lanes)
        r = rows[label]
        phase("K1", f"{label}: device ms per launch, each the mean of two turns {times}; "
                    f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}; {int(samples.sum())} "
                    f"samples marched; lane efficiency {lanes:.4f}); "
                    f"{r['blocks_per_sm']} blocks of 96 threads per SM; card {card}")
    main_row, m36_row = rows["4096x4 M=4"], rows["512x8 M=36"]
    ref = lidar_scan_ref(*main_args)
    kernels["lidar_scan"] = dict(
        name="lidar_scan", route="cuda", source=SRC + "lidar.cu",
        replaces="marl_traffic_intersection_tpu/ops/lidar_pallas.py:155",
        max_abs_err=float((lidar_scan(*main_args) - ref).abs().max()),
        ms=main_row["ms"]["lidar.cu"],
        event_ms=cuda_ms(lambda: lidar_scan(*main_args), 50),
        plain_ms=cuda_ms(lambda: lidar_scan_ref(*main_args), 5),
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"], library_ms=None,
        ms_m36=m36_row["ms"]["lidar.cu"], bound_ms_m36=m36_row["bound_ms"],
        plain_ms_m36=cuda_ms(lambda: lidar_scan_ref(*timed["512x8 M=36"]), 3),
        blocks_per_sm=main_row["blocks_per_sm"], blocks_per_sm_m36=m36_row["blocks_per_sm"],
        lane_efficiency=main_row["lane_efficiency"],
        lane_efficiency_m36=m36_row["lane_efficiency"],
        **kernel_regs(ptxas, "lidar_kernel"))
    if baselines:
        kernels["lidar_scan"]["baselines"] = [
            dict(source=d, ms=main_row["ms"][d], ms_m36=m36_row["ms"][d], **regs)
            for d, (_, regs) in baselines.items()]
    k = kernels["lidar_scan"]
    phase("K1", f"4096x4 M=4: device {k['ms']:.5f} ms (events, with the host: "
                f"{k['event_ms']:.4f}), plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.5f} "
                f"ms; 512x8 M=36: device {k['ms_m36']:.5f} ms, plain {k['plain_ms_m36']:.3f} ms, "
                f"bound {k['bound_ms_m36']:.5f} ms; {k['registers']} registers, "
                f"{k['spill_stores']} B spilled; card {card}")

    # ---- 5. main path: 4096 envs x 4 agents, bf16 MLP in the loop
    torch.manual_seed(0)
    model = ActorCriticMLP().to(dev)
    venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4), device=dev), num_envs=4096, seed=0)
    state, obs = venv.reset()
    for _ in range(5):                                  # warm-up
        state, out = venv.step(state, model.act(obs))
        obs = out.obs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    with k1_counted() as rec:
        t0 = time.perf_counter()
        for _ in range(200):
            state, out = venv.step(state, model.act(obs))
            obs = out.obs
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    if obs.shape != (4096, 4, 127) or not bool(torch.isfinite(obs).all()):
        phase("main", f"FAIL: obs {tuple(obs.shape)} finite={bool(torch.isfinite(obs).all())}")
        return 1
    if launches.get("lidar_scan", 0) != 200:
        phase("main", f"FAIL: K1 launched {launches.get('lidar_scan', 0)} times in 200 steps")
        return 1
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    held, bad = held_to_plain(rec, kernels)
    if missing or bad:
        phase("main", f"FAIL: kernels not launched on the main path: {missing}; {bad}")
        return 1
    for k in kernels:
        kernels[k]["launches"] = launches.get(k, 0)
    phase("main", f"4096x4, 200 steps, bf16 MLP in the loop: "
                  f"{4096 * 200 / secs:.1f} env-steps/s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}; "
                  f"the kernels on the last step's operands bit-equal to their plain versions: "
                  f"{held}; card {card}")
    time_recorded(rec, kernels, "main_path", tuple(LIBM), card)
    zeros = torch.zeros((4096, 4, 2), device=dev)
    prof = profile_steps(lambda: venv.step(state, zeros)[1].obs.sum(), 10)
    phase("main", f"profile of 10 steps, zero actions (as the bench): "
                  f"{prof['kernel_launches_per_step']:.1f} launches per step, device busy "
                  f"{prof['device_busy_ms_per_step']:.3f} of {prof['window_ms_per_step']:.3f} ms")

    # the whole slice, card against CPU, same resets and actions
    runs = {}
    for d in ("cpu", dev):
        e2 = IntersectionEnv(EnvConfig(num_agents=4, max_steps=40), device=d)
        pool = e2.table.route_ids(default_ego_routes(12, 3))
        rr = np.random.RandomState(6)

        def sampler(k, rr=rr, pool=pool, d=d):
            ids = np.stack([pool[rr.permutation(len(pool))[:4]] for _ in range(k)])
            return torch.from_numpy(ids.astype(np.int32)).to(d)

        v2 = VectorEnv(e2, num_envs=64, route_sampler=sampler)
        s2, o2 = v2.reset()
        ar = np.random.RandomState(7)
        hist = [o2.cpu()]
        for _ in range(100):
            a = torch.from_numpy(ar.uniform(-1, 1, (64, 4, 2)).astype(np.float32)).to(d)
            s2, out2 = v2.step(s2, a)
            hist += [out2.obs.cpu(), out2.reward.cpu(), out2.status.cpu(), out2.done.cpu(),
                     out2.terminated.cpu(), out2.truncated.cpu()]
            hist += [t.cpu() for t in s2.ego] + [s2.lidar.cpu(), s2.step_count.cpu()]
        runs[str(d)] = hist
    bad = [i for i, (a, b) in enumerate(zip(runs["cpu"], runs[str(dev)])) if not bits_equal(a, b)]
    if bad:
        phase("main", f"FAIL: card and CPU runs differ in {len(bad)} tensors, first #{bad[0]}")
        return 1
    phase("main", f"64x4, 100 steps: card run bit-equal to the CPU run ({len(runs['cpu'])} tensors)")

    own = {}        # kernels with a phase of their own: K2 (the NPC planner's move), K3
    for name, fn in (("graphs", graphs_phase), ("train", train_phase),
                     ("npc_move", lambda dev, card, kernels: npc_move_phase(dev, card, own)),
                     ("ego_step", lambda dev, card, kernels: ego_step_phase(dev, card, own)),
                     ("traffic", traffic_phase),
                     ("policies", policies_phase), ("learners", learners_phase),
                     ("resume", resume_phase), ("gym", gym_phase),
                     ("planning", planning_phase), ("distributed", distributed_phase)):
        if opts.phases and name not in opts.phases:
            continue
        t0 = time.perf_counter()
        if fn(dev, card, kernels):
            return 1
        phase(name, f"phase done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": list(kernels.values()) + list(own.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


GRAPH_STEPS = 200
# the kernels of phase 4's table that every env step launches: K1 and the
# observation's atan2f_diff (sincosf, tanf and hypotf_diff of the ego tick
# run inside K3; the NPC layer still launches sincosf and
# hypotf_diff); each phase fails if its steps left one of them out
STEP_KERNELS = ("lidar_scan", "atan2f_diff")
# the kernels' names in the profiler's records
PROFILED_NAME = {"lidar_scan": "lidar_kernel", "sincosf": "sincosf_kernel", "tanf": "TanF",
                 "atan2f_diff": "Atan2FDiff", "hypotf_diff": "HypotFDiff"}


def leaf_mismatches(a, b) -> torch.Tensor:
    """The count of elements in which two nests of tensors differ, by bit
    pattern, as a 0-d tensor on the card (no read)."""
    from marl_traffic_intersection_tpu_torch.utils.graphs import leaves

    out = torch.zeros((), dtype=torch.long, device="cuda")
    for x, y in zip(leaves(a), leaves(b)):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out += (x != y).sum()
    return out


def graphs_phase(dev, card, kernels) -> int:
    """The graphed main path (utils/graphs.py) against the eager one; 1 on
    failure. (a) VectorEnv.jit_step() and step at 4096 x 4, 200 steps in
    lockstep with episodes of 50 steps, the same routes and seeded actions:
    state, obs, reward and status bit-equal at every step. (b) Eager and
    graphed steps in turns (zero actions, as the bench): env-steps/s, the
    device busy share, the capture time and the launches per replay; K1
    launched once per graphed step, and K1 and every libm kernel on the
    graph's operands (the recorder active during the capture keeps them)
    bit-equal to their plain versions. (c) PPO at 4096 x 4, rollout 64, bf16
    MLP: two graphed train steps against two eager ones with capturable Adam
    from the same seeds, the trajectories, env states, observations, metrics,
    parameters and moments bit-equal, and the first rollout bit-equal to
    train's eager step's (the host's Adam); rollout_s and update_s and the
    busy share of each. (d) At the float32 learner check's size (64 x 4,
    rollout 16), the graphed update against train's eager one within its
    tolerances, the update moving the parameters more than ten times them."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps, records

    B, N = 4096, 4

    def venv_of(max_steps):
        return VectorEnv(IntersectionEnv(EnvConfig(num_agents=N, max_steps=max_steps),
                                         device=dev), num_envs=B, seed=0)

    # (a) lockstep, bit for bit at every step
    ev, gv = venv_of(50), venv_of(50)
    es, _ = ev.reset()
    gs, _ = gv.reset()
    gstep = gv.jit_step()
    gen = torch.Generator(device=dev).manual_seed(11)
    bad = torch.zeros((), dtype=torch.long, device=dev)
    resets = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(GRAPH_STEPS):
        a = torch.rand((B, N, 2), generator=gen, device=dev) * 2 - 1
        es, eo = ev.step(es, a)
        gs, go = gstep(gs, a)
        bad += leaf_mismatches((es, eo.obs, eo.reward, eo.status, eo.done),
                               (gs, go.obs, go.reward, go.status, go.done))
        resets += (eo.terminated | eo.truncated).sum()
    bad, resets = int(bad), int(resets)
    if bad or not resets:
        phase("graphs", f"FAIL: graphed and eager steps differ in {bad} elements over "
                        f"{GRAPH_STEPS} steps ({resets} resets)")
        return 1
    phase("graphs", f"{B}x{N}, {GRAPH_STEPS} steps with seeded actions, episodes of 50: the "
                    f"graphed step (jit_step) bit-equal to the eager step at every step (state, "
                    f"obs, reward, status, done); {resets} env resets")
    del ev, gv, es, gs, eo, go, gstep

    # (b) rates in turns, the graph's operands held to the plain versions
    ev, gv = venv_of(2000), venv_of(2000)
    es, _ = ev.reset()
    gs, _ = gv.reset()
    zeros = torch.zeros((B, N, 2), device=dev)
    for _ in range(5):
        es, eo = ev.step(es, zeros)
    with k1_counted() as rec:           # the capture's operands stay referenced
        gstep = gv.jit_step()
        for _ in range(5):              # the first call warms up, the second captures
            gs, go = gstep(gs, zeros)
    graph = gstep.graphs[("step", None, False)]

    def block(graphed):
        nonlocal es, gs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_STEPS):
            if graphed:
                gs, out = gstep(gs, zeros)
            else:
                es, out = ev.step(es, zeros)
        torch.cuda.synchronize()
        return B * GRAPH_STEPS / (time.perf_counter() - t0)

    rates = {"eager": [], "graphed": []}
    for graphed in (False, True, True, False):
        first = graphed and not rates["graphed"]
        if first:                       # the launch counters over the first graphed block
            native.reset_launches()
        rates["graphed" if graphed else "eager"].append(block(graphed))
        if first:
            launches = dict(native.LAUNCHES)
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    held, bad = held_to_plain(rec, kernels)
    if launches.get("lidar_scan", 0) != GRAPH_STEPS or missing or bad:
        phase("graphs", f"FAIL: in {GRAPH_STEPS} graphed steps K1 launched "
                        f"{launches.get('lidar_scan', 0)} times, never launched {missing}; {bad}")
        return 1
    profs = {name: profile_steps(fn, 20) for name, fn in (
        ("eager", lambda: ev.step(es, zeros)[1].obs.sum()),
        ("graphed", lambda: gstep(gs, zeros)[1].obs.sum()))}
    # each kernel's device time inside a replay, from a profile of 20 replays
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            gstep(gs, zeros)
        torch.cuda.synchronize()
    recs = records(prof)
    for k, row in kernels.items():
        hits = [(n, us) for name, (n, us) in recs.items() if PROFILED_NAME.get(k, k) in name]
        n, us = sum(h[0] for h in hits), sum(h[1] for h in hits)
        row["launches_graphed"] = launches.get(k, 0)
        row["launches_per_replay"] = graph.launches.get(k, 0)
        row["ms_in_replay"] = us / n / 1e3 if n else None
    phase("graphs", f"{B}x{N}, zero actions, {GRAPH_STEPS}-step blocks in turns (eager, "
                    f"graphed, graphed, eager): env-steps/s eager {rates['eager']}, graphed "
                    f"{rates['graphed']}; device busy per step eager "
                    f"{profs['eager']['device_busy_ms_per_step']:.4f} of "
                    f"{profs['eager']['window_ms_per_step']:.4f} ms "
                    f"({profs['eager']['device_busy_share']:.4f}), graphed "
                    f"{profs['graphed']['device_busy_ms_per_step']:.4f} of "
                    f"{profs['graphed']['window_ms_per_step']:.4f} ms "
                    f"({profs['graphed']['device_busy_share']:.4f}); kernels per step eager "
                    f"{profs['eager']['kernel_launches_per_step']:.1f}, graphed "
                    f"{profs['graphed']['kernel_launches_per_step']:.1f}; capture "
                    f"{graph.capture_s:.3f} s; our kernels' launches per replay "
                    f"{dict(graph.launches)}, device ms in a replay "
                    f"{ {k: kernels[k]['ms_in_replay'] for k in kernels} }; launches in "
                    f"{GRAPH_STEPS} graphed steps {launches}; the kernels on the graph's "
                    f"operands bit-equal to their plain versions: {held}; card {card}")
    del ev, gv, es, gs, eo, go, gstep, graph, rec
    torch.cuda.empty_cache()

    # (c) PPO at full width in bf16: graphed against eager capturable Adam,
    # bit for bit, and the rates of train's eager step (the host's Adam)
    runs = ppo_runs(dev, B, TRAIN_T, {}, ("host adam", "capturable adam", "graphed"))
    g, c = runs["graphed"], runs["capturable adam"]
    bad = sum(int(leaf_mismatches([g["trajs"][u], list(g["after"][u].values())],
                                  [c["trajs"][u], list(c["after"][u].values())]))
              for u in range(2))
    bad_first = int(leaf_mismatches(g["trajs"][0], runs["host adam"]["trajs"][0]))
    msg = (f"PPO {B}x{N}, rollout {TRAIN_T}, bf16 MLP: 2 graphed train steps against 2 eager "
           f"ones with capturable Adam: {bad} elements differ (trajectories, env states, "
           f"observations, metrics, parameters, Adam's moments); the first rollout against "
           f"train's eager step (the host's Adam): {bad_first} elements differ")
    if bad or bad_first:
        phase("graphs", "FAIL: " + msg)
        return 1
    phase("graphs", msg)
    phase("graphs", "PPO rollout_s/update_s by update: " + "; ".join(
        f"{name} {[(round(s['rollout_s'], 4), round(s['update_s'], 4)) for s in r['splits']]}, "
        f"a third update profiled: device busy {r['prof']['device_busy_ms_per_step']:.2f} of "
        f"{r['prof']['window_ms_per_step']:.2f} ms ({r['prof']['device_busy_share']:.4f}), "
        f"{r['prof']['kernel_launches_per_step']:.0f} kernels" for name, r in runs.items())
        + "; graphs: " + ", ".join(f"{k} capture {v.capture_s:.3f} s, {v.replays} replays, "
                                    f"our kernels per replay {dict(v.launches)}"
                                    for k, v in g["graphs"].items()) + f"; card {card}")

    # (d) the graphed update against train's eager one (the host's Adam) at
    # the float32 learner check's size and tolerances: capturable Adam takes
    # its bias corrections in float32 on the card, the host's in float64, and
    # PPO's clipped objective carries such differences on through the
    # minibatches (at 4096 x 4 x 64 on an H100: parameters 3.3e-6 apart and
    # moments 4.0e-4 of their largest in float32, 1.9e-5 and 1.2e-2 in bf16)
    PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4
    f32 = dict(compute_dtype=torch.float32)
    runs = ppo_runs(dev, 64, 16, f32, ("host adam", "graphed"))
    g, h = runs["graphed"], runs["host adam"]
    bad_first = int(leaf_mismatches(g["trajs"][0], h["trajs"][0]))
    gp, hp = g["after"][0]["params"], h["after"][0]["params"]
    diff = max(float((a - b).abs().max()) for a, b in zip(gp, hp))
    mdiff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for ga, ha in zip(g["after"][0]["moments"], h["after"][0]["moments"])
                for a, b in zip(ga, ha))
    init = [p.detach().to(dev) for p in make_model("mlp", seed=3, **f32).parameters()]
    moved = max(float((a - b).abs().max()) for a, b in zip(hp, init))
    msg = (f"PPO 64x{N}, rollout 16, float32 MLP: the graphed train step against train's eager "
           f"one (the host's Adam): the rollout {bad_first} elements apart; after the update, "
           f"parameters within {diff:.3g} (tolerance {PARAM_TOL}), Adam's moments within "
           f"{mdiff:.3g} of their largest (tolerance {MOMENT_TOL}), the update moved the "
           f"parameters up to {moved:.3g}")
    if bad_first or not (diff <= PARAM_TOL and mdiff <= MOMENT_TOL and moved > 10 * PARAM_TOL):
        phase("graphs", "FAIL: " + msg)
        return 1
    phase("graphs", msg)
    return 0


def ppo_runs(dev, B, T, model_kw, names, profile=True, **env_kw) -> dict:
    """PPO at B x 4, rollout T, from the same seeds, for each of ``names``:
    "host adam" (train's eager step, 1 update), "capturable adam" (the eager
    step with capturable Adam, 2 updates), "graphed" (jit_train_step, 2
    updates); each then profiles one more update (with ``profile``).
    ``env_kw`` goes to the env's EnvConfig (traffic). Per name: the
    trajectories, and after each update the env state, observation,
    metrics, parameters, Adam's moments (copies) and the env's npc_stats,
    the splits, the profile and the graphed step's graphs."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.utils.graphs import stat_counts
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner
    from marl_traffic_intersection_tpu_torch.utils.graphs import capturable_, leaves
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    runs = {}
    for name in names:
        venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4, **env_kw), device=dev),
                         num_envs=B, seed=0)
        lrn = PPOLearner(venv, make_model("mlp", seed=3, **model_kw),
                         PPOConfig(rollout_len=T), seed=4)
        ts = lrn.init()
        capturable_(ts.optimizer, name != "host adam")
        state, obs = venv.reset()
        trajs, after, splits = [], [], []
        step = lrn.jit_train_step() if name == "graphed" else lrn.train_step
        for _ in range(1 if name == "host adam" else 2):
            split = {}
            ts, state, obs, metrics = step(ts, state, obs, split)
            trajs.append(tuple(t.clone() for t in (step if name == "graphed" else lrn.eager).traj))
            after.append(dict(
                state=[t.clone() for t in leaves(state)], obs=obs.clone(),
                metrics=torch.stack(list(metrics.values())),
                params=[p.detach().clone() for p in ts.model.parameters()],
                moments=[[ts.optimizer.state[p][m].clone() for m in ("exp_avg", "exp_avg_sq")]
                         for p in ts.model.parameters()],
                npc_stats=stat_counts(venv.env.npc_stats)))
            splits.append(split)
        prof = profile_steps(lambda: step(ts, state, obs), 1) if profile else None
        runs[name] = dict(trajs=trajs, after=after, splits=splits, prof=prof,
                          graphs=step.graphs if name == "graphed" else None)
        del lrn, ts, state, obs, step
        torch.cuda.empty_cache()
    return runs


def json_lines(main, argv, tag):
    """``main(argv)`` of an entry point, its output echoed under ``tag``;
    returns its JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = []
    for ln in buf.getvalue().splitlines():
        phase(tag, ln)
        if ln.startswith("{"):
            lines.append(json.loads(ln))
    return lines


def run_train(argv, tag="train"):
    """``train.main(argv)``, its output echoed; returns its JSON log lines and
    its profile line (None without --profile)."""
    from marl_traffic_intersection_tpu_torch import train

    lines = json_lines(train.main, argv, tag)
    profs = [ln["profile"] for ln in lines if "profile" in ln]
    return [ln for ln in lines if "update" in ln], (profs[0] if profs else None)


def losses_finite(logs):
    return bool(logs) and all(np.isfinite([ln[k] for k in ("pg_loss", "v_loss", "entropy",
                                                            "approx_kl")]).all() for ln in logs)


def split_line(name, logs, prof, peak, card, tag="train"):
    """The rollout/update split of the logged updates after the first (warm-up)
    and before a profiled one, peak memory and the profile, as one phase line."""
    timed = logs[1:-1] if prof else logs[1:]
    roll = [ln["rollout_s"] for ln in timed]
    upd = [ln["update_s"] for ln in timed]
    steps = TRAIN_B * TRAIN_T * len(timed)
    top = [(k["name"][:60], round(k["ms_per_step"], 2), k["launches_per_step"])
           for k in (prof or {}).pop("top_kernels", [])]
    phase(tag, f"{name}: rollout s {roll}, update (GAE + 16 minibatches) s {upd}; "
                   f"{steps / sum(roll + upd):.1f} env-steps/s; peak memory "
                   f"{peak / 2**20:.1f} MiB; profile of the last update {json.dumps(prof)}; "
                   f"top kernels (name, ms, launches): {top}; card {card}")


TRAIN_B, TRAIN_N, TRAIN_T = 4096, 4, 64
TRACES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def train_phase(dev, card, kernels) -> int:
    """Phase 6 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner, Transition
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint

    B, N, T = TRAIN_B, TRAIN_N, TRAIN_T
    size = ["--num-envs", str(B), "--agents", str(N), "--rollout-len", str(T), "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        argv = size + ["--checkpoint", os.path.join(tmp, "run")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        t0 = time.perf_counter()
        with k1_counted() as rec:
            logs, _ = run_train(argv + ["--updates", "3"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        saved = restore_checkpoint(argv[-1])
        if len(logs) != 3 or not losses_finite(logs):
            phase("train", f"FAIL: {len(logs)} log lines, losses finite: {losses_finite(logs)}")
            return 1
        if saved["update_count"] != 3 * 16 or launches.get("lidar_scan", 0) != 3 * T:
            phase("train", f"FAIL: update_count {saved['update_count']} (want 48), K1 launched "
                           f"{launches.get('lidar_scan', 0)} times (want {3 * T})")
            return 1
        missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
        held, bad = held_to_plain(rec, kernels)
        if missing or bad:
            phase("train", f"FAIL: kernels not launched in training: {missing}; {bad}")
            return 1
        for k in kernels:
            kernels[k]["launches_train"] = launches.get(k, 0)
        phase("train", f"{B}x{N}, rollout {T}, 3 updates in {secs:.3f} s (builds warm): "
                       f"env-steps/s by update {[ln['env_steps_per_s'] for ln in logs]}, "
                       f"launches {launches}; the kernels on the last step's operands "
                       f"bit-equal to their plain versions: {held}")
        split_line("mlp", logs, None, peak, card)
        resumed, prof = run_train(argv + ["--updates", "4", "--profile",
                                          os.path.join(TRACES, "train_mlp.json.gz")])
        saved = restore_checkpoint(argv[-1])
        if ([ln["update"] for ln in resumed] != [3] or not losses_finite(resumed)
                or saved["update"] != 4 or saved["update_count"] != 16):
            phase("train", f"FAIL: the auto-resumed run logged {resumed}, saved update "
                           f"{saved['update']} count {saved['update_count']}")
            return 1
        phase("train", f"auto-resume ran update 3 from the checkpoint of update 3; its "
                       f"profile {json.dumps(prof)}")

    # every other family (and the reward normaliser) through the same entry point
    for kind, extra, trace in (("mlp", ["--norm-reward"], "mlp_norm"), ("conv", [], "conv"),
                               ("central", [], "central"), ("attention", [], "attention")):
        name = " ".join([kind] + extra)
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        logs, prof = run_train(size + ["--updates", "4", "--model", kind, "--seed", "1", *extra,
                                       "--profile", os.path.join(TRACES, f"train_{trace}.json.gz")])
        peak = torch.cuda.max_memory_allocated()
        k1 = native.LAUNCHES.get("lidar_scan", 0)
        if len(logs) != 4 or not losses_finite(logs) or k1 != 4 * T:
            phase("train", f"FAIL: {name}: {len(logs)} log lines, losses finite "
                           f"{losses_finite(logs)}, K1 launched {k1} times (want {4 * T})")
            return 1
        split_line(name, logs, prof, peak, card)
        torch.cuda.empty_cache()

    # one update of one fixed CPU trajectory, on the CPU and on the card, in
    # float32: cuBLAS and the CPU sum in other orders, so the parameters are
    # held within PARAM_TOL and Adam's moments within MOMENT_TOL of their
    # largest (tests/test_torch_ppo.py measured 9e-8 and 1.1e-6 against
    # optax); the update must move the parameters far beyond PARAM_TOL, or
    # the comparison could not tell it from no update at all
    PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4
    cfg16 = PPOConfig(rollout_len=16)
    f32 = dict(compute_dtype=torch.float32)
    cpu_venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4), device="cpu"), num_envs=64,
                         seed=3)
    g = torch.Generator().manual_seed(9)
    perms = [torch.randperm(16, generator=g) for _ in range(cfg16.update_epochs)]
    updated = {}
    for d in ("cpu", dev):
        queue = [p.to(d) for p in perms]
        ven = cpu_venv if d == "cpu" else VectorEnv(
            IntersectionEnv(EnvConfig(num_agents=4), device=d), num_envs=64)
        lrn = PPOLearner(ven, make_model("mlp", seed=5, **f32), cfg16, seed=4,
                         perm_fn=lambda n, q=queue: q.pop(0))
        t_s = lrn.init()
        if d == "cpu":
            s0, o0 = cpu_venv.reset()
            _, _, traj_cpu, lv = lrn.rollout(t_s, s0, o0)
            advs_cpu, rets_cpu = lrn._gae(traj_cpu, lv)
        tr = Transition(*(t.to(d) for t in traj_cpu))
        t_s, _ = lrn.update(t_s, tr, advs_cpu.to(d), rets_cpu.to(d))
        st = t_s.optimizer.state
        updated[str(d)] = {k: [v.detach().cpu()] + [st[v][m].cpu() for m in ("exp_avg",
                                                                              "exp_avg_sq")]
                           for k, v in t_s.model.named_parameters()}
    cpu, gpu = updated["cpu"], updated[str(dev)]
    steps = cfg16.update_epochs * cfg16.num_minibatches
    diff = max(float((cpu[k][0] - gpu[k][0]).abs().max()) for k in cpu)
    over = sum(int(((cpu[k][0] - gpu[k][0]).abs() > PARAM_TOL).sum()) for k in cpu)
    mdiff = max(float((cpu[k][i] - gpu[k][i]).abs().max() / cpu[k][i].abs().max())
                for k in cpu for i in (1, 2))
    moved = max(float((cpu[k][0] - v.detach()).abs().max())
                for k, v in make_model("mlp", seed=5, **f32).named_parameters())
    msg = (f"64x4x16 CPU trajectory, one update ({steps} Adam steps, float32): card vs CPU "
           f"parameters within {diff:.3g} ({over} elements over {PARAM_TOL}), Adam moments "
           f"within {mdiff:.3g} of their largest (tolerance {MOMENT_TOL}); the update moved the "
           f"parameters up to {moved:.3g}")
    if not (diff <= PARAM_TOL and mdiff <= MOMENT_TOL and moved > 10 * PARAM_TOL):
        phase("train", "FAIL: " + msg)
        return 1
    phase("train", msg)
    return 0


TRAFFIC_B, TRAFFIC_N, TRAFFIC_STEPS = 4096, 8, 200
TRAFFIC_CFG = dict(num_agents=TRAFFIC_N, traffic_flow=True, traffic_density=1.0, max_npcs=32)
# the card-against-CPU run: a spawn try every step and episodes of 175 steps
# in 200, so that the exact mode's cleanup replays and collision cascade run
# (on the CPU: 606 and 19 rounds) and every env resets mid-run
TRY_P, TRY_MAX_STEPS, TRY_STEPS = 1.0, 175, 200


def k1_bound(B, N, M, samples):
    """K1's least time in ms and what bounds it: ~20 operations per marched
    sample (sample, screen, road) and 4 compares per ray and obstacle (the
    cull) at the f32 peak; each input read once and the output written once."""
    ops = float(samples.sum()) * 20 + B * N * 96 * M * 4
    nbytes = 3 * B * N * 4 + 3 * B * M * 4 + B * M + B * N * 96 * 4
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), \
        "bytes" if by_bytes else "operations"


@contextlib.contextmanager
def k1_counted():
    """K1's launches by obstacle count M (``.by_m``) while the block runs, the
    env's ``lidar_scan`` wrapped; ``.args`` keeps the last launch's arguments,
    ``.args_by_m`` the last launch's at each M, and ``.libm`` each libm
    kernel's last operands on the card at each shape it launched at, keyed
    (name, shape), for ``held_to_plain``."""
    from marl_traffic_intersection_tpu_torch.core import env as env_module
    from marl_traffic_intersection_tpu_torch.ops import libm

    scan, apply = env_module.lidar_scan, libm._apply
    rec = types.SimpleNamespace(by_m=collections.Counter(), args=None, args_by_m={}, libm={})

    def counted(*args, **kw):
        rec.by_m[args[3].shape[1]] += 1
        rec.args = rec.args_by_m[args[3].shape[1]] = args
        return scan(*args, **kw)

    def recorded(name, *xs):
        if xs[0].is_cuda:
            rec.libm[name, tuple(torch.broadcast_shapes(*(x.shape for x in xs)))] = xs
        return apply(name, *xs)

    env_module.lidar_scan, libm._apply = counted, recorded
    try:
        yield rec
    finally:
        env_module.lidar_scan, libm._apply = scan, apply


def held_to_plain(rec, kernels) -> tuple:
    """K1 (if in ``kernels``) on the last arguments ``k1_counted`` kept at each
    obstacle count M, and every libm kernel of ``kernels`` on its last
    operands at each shape it launched at (both outputs of sincosf; atan2f
    and hypotf, which launch the diff kernels, as called), against their
    plain versions (``lidar_scan_ref``; the same wrapper on the CPU, the host
    glibc), bit for bit: (the shapes held, the failures)."""
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.ops import libm, lidar_cuda

    held, bad = [], []
    if "lidar_scan" in kernels and not rec.args_by_m:
        bad.append("lidar_scan never launched")
    for M, args in sorted(rec.args_by_m.items() if "lidar_scan" in kernels else ()):
        got, ref = lidar_cuda.lidar_scan(*args), lidar_scan_ref(*args)
        B, N = args[0].shape
        held.append(f"lidar_scan {B}x{N} M={M}")
        if not bits_equal(got, ref):
            bad.append(f"lidar_scan differs from lidar_scan_ref on "
                       f"{int((got.cpu().view(torch.int32) != ref.cpu().view(torch.int32)).sum())}"
                       f" rays at {held[-1]}")
    launched = {libm.KERNEL_OF.get(name, name) for name, _ in rec.libm}
    bad += [f"{name} never launched" for name in kernels
            if name in STEP_KERNELS and name != "lidar_scan" and name not in launched]
    for (name, shape), xs in sorted(rec.libm.items()):
        if libm.KERNEL_OF.get(name, name) not in kernels:
            continue
        fn = getattr(libm, name)
        got, want = outputs(fn(*xs)), outputs(fn(*(x.cpu() for x in xs)))
        held.append(f"{name} {shape}")
        for g, w in zip(got, want):
            if not bits_equal(g, w):
                bad.append(f"{name} differs from its CPU build on "
                           f"{int((g.cpu().view(torch.int32) != w.view(torch.int32)).sum())} of "
                           f"{g.numel()} operands at {shape}")
    return held, bad


def time_recorded(rec, kernels, key, names, card) -> None:
    """Each libm function of ``names`` timed (libm_times, against LIBM_BASES)
    on the last operands ``rec`` kept at each shape it launched at, those of
    the strided kernels on the views as they were passed, the others made
    contiguous; the times appended to its kernel's ``kernels[kernel][key]``."""
    from marl_traffic_intersection_tpu_torch.ops import libm

    for (name, shape), xs in sorted(rec.libm.items()):
        if name not in names:
            continue
        kernel = libm.KERNEL_OF.get(name, name)
        args = (list(xs) if kernel in libm.DIFF
                else [t.contiguous() for t in torch.broadcast_tensors(*xs)])
        times = libm_times(name, args, LIBM_BASES)
        kernels[kernel].setdefault(key, []).append(dict(function=name, shape=list(shape),
                                                        **times))
        phase("libm", f"{name} on the {key.replace('_', ' ')}'s last operands at {shape}: "
                      f"device ms per call {per_variant(times)}; bound {times['bound_ms']:.7f} "
                      f"ms ({times['bound_by']}); card {card}")


def held_seen(rec, kernels) -> tuple:
    """``held_to_plain`` for the kernels of ``kernels`` that ``rec`` saw
    launched."""
    from marl_traffic_intersection_tpu_torch.ops import libm

    seen = ({libm.KERNEL_OF.get(name, name) for name, _ in rec.libm}
            | ({"lidar_scan"} if rec.args_by_m else set()))
    return held_to_plain(rec, {k: v for k, v in kernels.items() if k in seen})


def traffic_runs(dev, modes, B=64):
    """The histories of ``B`` envs of config 4 on ``dev``, at the full NPC
    width, over TRY_STEPS steps for each (npc_mode, npc_cleanup) in
    ``modes``, with the same resets, actions and injected spawns; the first
    run's NPC-steps (alive NPCs summed over steps); and each run's
    ``npc_stats`` (the exact mode's loop rounds and device reads) with its
    seconds."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.core.routes import default_ego_routes

    runs, alive, stats = {}, 0, {}
    for mode, cleanup in modes:
        t0 = time.perf_counter()
        env = IntersectionEnv(EnvConfig(npc_mode=mode, npc_cleanup=cleanup, npc_tier=0,
                                        max_steps=TRY_MAX_STEPS, **TRAFFIC_CFG), device=dev)
        pool = env.table.route_ids(default_ego_routes(12, 3))
        T = env.traffic_ids.shape[0]
        rr, sr, ar = (np.random.RandomState(s) for s in (6, 8, 7))

        def routes(k, rr=rr, pool=pool):
            ids = np.stack([pool[rr.permutation(len(pool))[:TRAFFIC_N]] for _ in range(k)])
            return torch.from_numpy(ids.astype(np.int32)).to(dev)

        def spawns(k, sr=sr, T=T):
            return (torch.from_numpy(sr.uniform(size=k) < TRY_P).to(dev),
                    torch.from_numpy(sr.randint(T, size=k).astype(np.int32)).to(dev))

        venv = VectorEnv(env, num_envs=B, route_sampler=routes, spawn_sampler=spawns)
        st, obs = venv.reset()
        hist = [obs.cpu()]
        npc_steps = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(TRY_STEPS):
            # mostly forward, so that the egos leave the spawn points to the NPCs
            a = np.stack([ar.uniform(0.2, 1.0, (B, TRAFFIC_N)),
                          ar.uniform(-0.2, 0.2, (B, TRAFFIC_N))], -1).astype(np.float32)
            st, out = venv.step(st, torch.from_numpy(a).to(dev))
            hist += [out.obs.cpu(), out.reward.cpu(), out.status.cpu(), out.done.cpu(),
                     out.terminated.cpu(), out.truncated.cpu(), out.spawned.cpu()]
            hist += [t.cpu() for t in (*st.ego, *st.npc, st.lidar, st.step_count)]
            npc_steps += st.npc.alive.sum()
        runs[(mode, cleanup)] = hist
        stats[(mode, cleanup)] = dict(env.npc_stats, secs=round(time.perf_counter() - t0, 2))
        if len(runs) == 1:
            alive = int(npc_steps)
    return runs, alive, stats


def npc_breakdown(env, state, width) -> dict:
    """Device and wall ms per call of the exact NPC update and of its dense
    ghost-scan plan alone, on the first ``width`` slots of ``state``'s NPC pool
    (torch.profiler, 5 calls, each window ending in a synchronize)."""
    from marl_traffic_intersection_tpu_torch.core import npc as npc_module
    from marl_traffic_intersection_tpu_torch.core.constants import DT_DEFAULT, PATH_LEN
    from marl_traffic_intersection_tpu_torch.core.physics import update_path_index
    from marl_traffic_intersection_tpu_torch.ops import libm
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    pool, ego, dev = state.npc, state.ego, env.device
    pool = type(pool)(*(a[:, :width] if a.dim() >= 2 else a for a in pool))
    B, M = pool.alive.shape
    paths = env.paths[pool.route_id.long()]
    pi0 = update_path_index(paths, PATH_LEN, pool.path_index, pool.x, pool.y)
    others = pool.alive[:, None, :] & ~torch.eye(M, dtype=torch.bool, device=dev)
    no_spawn = (torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    poses = (pool.x, pool.y, pool.v, pool.heading, pool.uid)
    parts = {
        "npc_traffic_update exact slot": lambda: npc_module.npc_traffic_update(
            pool, env.paths, env.goal_xy, env.spawn_xy, env.spawn_heading, env.traffic_ids,
            ego.x, ego.y, torch.ones_like(ego.alive), *no_spawn, libm.const(DT_DEFAULT, dev)),
        f"dense plan ({B}, {M}, {M}, {PATH_LEN})": lambda: npc_module._plan(*poses, others, pi0, paths,
                                                                poses),
    }
    out = {}
    for name, fn in parts.items():
        prof = profile_steps(fn, 5)
        out[name] = {k: round(prof[k], 3) for k in ("device_busy_ms_per_step",
                                                    "window_ms_per_step",
                                                    "kernel_launches_per_step")}
    return out


def traffic_run(dev, card, kernels, model, label, steps, profile, warmup=5, time_libm=False,
                **cfg) -> dict:
    """``steps`` steps of config 4 at TRAFFIC_B x TRAFFIC_N with ``model`` in
    the loop, spawns drawn on the card (VectorEnv seed 2, so every run of the
    same ``cfg`` sees the same resets, spawns and actions), after ``warmup``
    steps: its phase line, and a dict of what it read (None on failure).
    With ``time_libm``, the diff forms and hypotf are timed on the last
    operands of each shape they launched at."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    B, N = TRAFFIC_B, TRAFFIC_N
    env = IntersectionEnv(EnvConfig(**{**TRAFFIC_CFG, **cfg}), device=dev)
    venv = VectorEnv(env, num_envs=B, seed=2)
    slots = env.config.max_npcs
    state, obs = venv.reset()
    for _ in range(warmup):
        state, out = venv.step(state, model.act(obs))
        obs = out.obs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    env.npc_stats.clear()
    alive = torch.zeros((steps, B), dtype=torch.int32, device=dev)
    spawned = torch.zeros((), dtype=torch.int64, device=dev)
    with k1_counted() as k1:
        t0 = time.perf_counter()
        for t in range(steps):
            state, out = venv.step(state, model.act(obs))
            obs = out.obs
            alive[t] = state.npc.alive.sum(1)
            spawned += out.spawned.sum()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    stats = dict(env.npc_stats)
    peak = torch.cuda.max_memory_allocated()
    final = [t.clone() for t in (*state.ego, *state.npc, state.lidar, state.step_count, obs)]
    finite = bool(torch.isfinite(obs).all())
    allowed = {N + w for w in venv.npc_widths + [slots]}
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    if (obs.shape != (B, N, 127) or not finite or int(spawned) == 0
            or sum(k1.by_m.values()) != steps or launches.get("lidar_scan", 0) != steps
            or not set(k1.by_m) <= allowed or missing):
        phase("traffic", f"FAIL {label}: obs {tuple(obs.shape)} finite={finite}, "
                         f"{int(spawned)} NPCs spawned; K1 launches by obstacle count "
                         f"{dict(k1.by_m)} (want {steps} at M in {sorted(allowed)}); kernels "
                         f"not launched {missing}")
        return None
    # K1 is held per M by the traffic phase; here the libm kernels, per shape
    held, bad = held_to_plain(k1, {k: v for k, v in kernels.items() if k != "lidar_scan"})
    if bad:
        phase("traffic", f"FAIL {label}: {bad}")
        return None
    if time_libm:
        time_recorded(k1, kernels, "traffic_path", ("atan2f_diff", "hypotf_diff", "hypotf"),
                      card)
    widths = {k: v for k, v in stats.items() if "_width_" in k}
    prof, top, breakdown = None, None, None
    if profile:
        carry = [state, obs]

        def step():
            carry[0], o = venv.step(carry[0], model.act(carry[1]))
            carry[1] = o.obs
        prof = profile_steps(step, 5)
        top = [(k["name"][:60], round(k["ms_per_step"], 3), k["launches_per_step"])
               for k in prof.pop("top_kernels")[:8]]
        # the exact NPC update and its plan at the width most steps ran
        ran = {int(k.rsplit("_", 1)[1]): v for k, v in widths.items()}
        if env.config.npc_mode == "exact":
            breakdown = npc_breakdown(env, carry[0], max(ran, key=ran.get, default=slots))
    per_env = alive.float()
    reads = stats.get("host_reads", 0) / steps
    phase("traffic", f"config 4 {label}, {B}x{N}, {steps} steps, bf16 MLP in the loop: "
                     f"{B * steps / secs:.1f} env-steps/s; {int(spawned)} NPCs spawned; "
                     f"alive slots per env: batch max {int(alive.max())}, mean "
                     f"{float(per_env.mean()):.3f}, batch max by step mean "
                     f"{float(per_env.amax(1).mean()):.2f}; widths run {widths}; K1 launches by "
                     f"M {dict(k1.by_m)}; kernel launches {launches} "
                     f"({sum(launches.values()) / steps:.1f} per step); the libm kernels on "
                     f"the last step's operands bit-equal to their plain versions: {held}; "
                     f"device reads and NPC loop rounds {stats} ({reads:.2f} reads per step); peak memory "
                     f"{peak / 2**20:.1f} MiB; profile of 5 steps {json.dumps(prof)}; top "
                     f"kernels (name, ms, launches per step) {top}; where the NPC update's "
                     f"device time goes {json.dumps(breakdown)}; card {card}")
    return dict(rate=B * steps / secs, launches=launches, k1_args=k1.args_by_m, final=final,
                by_m=dict(k1.by_m), widths=widths, reads=reads, peak=peak)


def traffic_turns(dev, card, kernels, model, label, lock=30, block=40, warmup=50,
                  replay_times=False, **cfg):
    """Config 4 at TRAFFIC_B x TRAFFIC_N (``cfg`` over TRAFFIC_CFG), the eager
    step against the graphed one (VectorEnv.jit_step: the step's segments
    replayed as CUDA graphs between the host's reads), two VectorEnvs of one
    seed with ``model`` in the loop. ``warmup`` graphed steps first (the
    captures; K1's and the libm kernels' operands recorded while capturing
    are held to their plain versions); the eager env then takes the
    graphed one's state and generator. ``lock`` steps in lockstep on the
    same actions: state, obs, reward, status, done and the episode and
    spawn flags bit-equal at every step, and the npc_stats (host reads,
    widths, loop rounds) equal. Then ``block``-step blocks in turns (eager,
    graphed, graphed, eager; each pair on the same steps, so the npc_stats
    of each pair must be equal too; a segment first met in a block is
    captured there, and each block's rate is also given without its
    captures' seconds), a profile of 5 steps of each, and the final states
    bit-equal. With ``replay_times`` each kernel's launches in
    the first graphed block and its device time inside a replay go to the
    kernel line. Returns what it read (None on failure)."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.utils.graphs import stat_counts
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.utils.graphs import clone_tree
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps, records

    B = TRAFFIC_B

    def venv_of():
        return VectorEnv(IntersectionEnv(EnvConfig(**{**TRAFFIC_CFG, **cfg}), device=dev),
                         num_envs=B, seed=2)

    t_start = time.perf_counter()
    ev, gv = venv_of(), venv_of()
    gs, gobs = gv.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with k1_counted() as rec:           # the captures' operands stay referenced
        gstep = gv.jit_step()
        for _ in range(warmup):
            gs, out = gstep(gs, model.act(gobs))
            gobs = out.obs
        torch.cuda.synchronize()
    warm_s, peak_warm = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    reserved_warm = torch.cuda.memory_reserved()
    held, bad = held_to_plain(rec, kernels)
    if bad:
        phase("traffic", f"FAIL {label}: on the graphs' operands {bad}")
        return None
    es, eobs = clone_tree(gs), gobs.clone()
    ev.generator.set_state(gv.generator.get_state())
    ev.env.npc_stats.clear()
    gv.env.npc_stats.clear()
    bad = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(lock):
        a = model.act(eobs)
        es, eo = ev.step(es, a)
        gs, go = gstep(gs, a)
        bad += leaf_mismatches((es, eo), (gs, go))
        eobs, gobs = eo.obs, go.obs
    bad, stats = int(bad), (stat_counts(ev.env.npc_stats), stat_counts(gv.env.npc_stats))
    if bad or stats[0] != stats[1]:
        phase("traffic", f"FAIL {label}: graphed and eager steps differ in {bad} elements over "
                         f"{lock} lockstep steps; npc_stats eager {stats[0]}, graphed {stats[1]}")
        return None

    def run_block(graphed):
        nonlocal es, gs, eobs, gobs
        venv = gv if graphed else ev
        venv.env.npc_stats.clear()
        native.reset_launches()
        captured = sum(g.capture_s for g in gstep.graphs.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(block):
            if graphed:
                gs, o = gstep(gs, model.act(gobs))
                gobs = o.obs
            else:
                es, o = ev.step(es, model.act(eobs))
                eobs = o.obs
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        captured = sum(g.capture_s for g in gstep.graphs.values()) - captured
        return dict(rate=B * block / secs, rate_no_capture=B * block / (secs - captured),
                    capture_s=captured, stats=stat_counts(venv.env.npc_stats),
                    launches=dict(native.LAUNCHES), peak=torch.cuda.max_memory_allocated(),
                    reserved=torch.cuda.memory_reserved())

    blocks = [run_block(g) for g in (False, True, True, False)]
    if blocks[0]["stats"] != blocks[1]["stats"] or blocks[2]["stats"] != blocks[3]["stats"]:
        phase("traffic", f"FAIL {label}: npc_stats of the blocks (eager, graphed, graphed, "
                         f"eager) {[b['stats'] for b in blocks]}")
        return None

    def eager_step():
        nonlocal es, eobs
        es, o = ev.step(es, model.act(eobs))
        eobs = o.obs

    def graphed_step():
        nonlocal gs, gobs
        gs, o = gstep(gs, model.act(gobs))
        gobs = o.obs
    profs = {"eager": profile_steps(eager_step, 5), "graphed": profile_steps(graphed_step, 5)}
    final_bad = int(leaf_mismatches((es, eobs), (gs, gobs)))
    if final_bad:
        phase("traffic", f"FAIL {label}: the final states differ in {final_bad} elements")
        return None
    if replay_times:            # each kernel's device time inside 5 more replayed steps
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                graphed_step()
            torch.cuda.synchronize()
        recs = records(prof)
        for k, row in kernels.items():
            hits = [(n, us) for name, (n, us) in recs.items() if PROFILED_NAME.get(k, k) in name]
            n, us = sum(h[0] for h in hits), sum(h[1] for h in hits)
            row["launches_traffic_graphed"] = blocks[1]["launches"].get(k, 0)
            row["ms_in_traffic_replay"] = us / n / 1e3 if n else None
    graphs = gstep.graphs
    per_step = lambda b, k: round(b["stats"].get(k, 0) / block, 3)
    rates = [round(b["rate"], 1) for b in blocks]
    line = dict(
        rates=rates, rates_without_captures=[round(b["rate_no_capture"], 1) for b in blocks],
        capture_s_in_blocks=[round(b["capture_s"], 3) for b in blocks],
        peak_mib=[round(b["peak"] / 2**20, 1) for b in blocks],
        reserved_mib=[round(b["reserved"] / 2**20, 1) for b in blocks],
        peak_warm_mib=round(peak_warm / 2**20, 1), reserved_warm_mib=round(reserved_warm / 2**20, 1),
        secs=round(time.perf_counter() - t_start, 1),
        reads=[per_step(b, "host_reads") for b in blocks],
        cleanup_rounds=[per_step(b, "cleanup_rounds") for b in blocks],
        collision_rounds=[per_step(b, "collision_rounds") for b in blocks],
        widths={k: v for k, v in blocks[1]["stats"].items() if "_width_" in k},
        ours_per_step=[round(sum(b["launches"].values()) / block, 2) for b in blocks],
        graphs=len(graphs), capture_s=round(sum(g.capture_s for g in graphs.values()), 3),
        **{f"{k}_{name}": round(p[f], 4) for name, p in profs.items()
           for k, f in (("device_ms", "device_busy_ms_per_step"),
                        ("window_ms", "window_ms_per_step"),
                        ("busy", "device_busy_share"),
                        ("launches", "kernel_launches_per_step"))})
    phase("traffic", f"graphed vs eager, config 4 {label}, {B}x{TRAFFIC_N}, bf16 MLP in the "
                     f"loop: {warmup} graphed warm-up steps ({warm_s:.2f} s with the captures), "
                     f"{lock} lockstep steps bit-equal at every step (state, obs, reward, status, "
                     f"done, flags) with equal npc_stats, {block}-step blocks in turns (eager, "
                     f"graphed, graphed, eager) with equal npc_stats per pair, final states "
                     f"bit-equal; {json.dumps(line)}; graphs by key and our kernels per replay "
                     f"{ {' '.join(map(str, k)): dict(g.launches) for k, g in graphs.items()} }; "
                     f"the kernels on the graphs' operands bit-equal to their plain versions: "
                     f"{held}; card {card}")
    return line


NPC_MOVE_ENVS = 256         # envs of each of ops/npc_move_cases.py's cases on the card
NPC_MOVE_TIERS = (-1, 16, 0)   # npc_tier: widths 8 (and 16 when crowded), 16, 32


def k2_bound(B, S, M):
    """K2's least time in ms and what bounds it: each planner's polyline,
    pose, uid, path index and row of ``others`` read once and its six results
    written once, the env's M poses read once; ~80 operations for each of its
    M pair terms (three hypotf and a sincosf), ~10 for each of its 120
    scanned points' distances and ~400 for the lookahead, the tick and the
    path-index window, at the f32 peak."""
    from marl_traffic_intersection_tpu_torch.core.constants import PATH_LEN

    nbytes = B * S * (PATH_LEN * 8 + 7 * 4 + M + 6 * 4) + B * M * 20
    ops = B * S * (M * 80 + 120 * 10 + 400)
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), \
        "bytes" if by_bytes else "operations"


@contextlib.contextmanager
def moves_recorded():
    """core/npc.py::_move wrapped while the block runs: ``.calls`` counts its
    calls by (S, M), ``.args`` keeps a copy of the last arguments of each
    (the cleanup rounds write the pool they read in place)."""
    from marl_traffic_intersection_tpu_torch.core import npc as npc_module

    move = npc_module._move
    rec = types.SimpleNamespace(calls=collections.Counter(), args={})

    def copy(a):
        return tuple(map(copy, a)) if isinstance(a, tuple) else a.clone()

    def recorded(*args):
        key = (args[0].shape[1], args[8].shape[-1])
        rec.calls[key] += 1
        rec.args[key] = copy(args)
        return move(*args)

    npc_module._move = recorded
    try:
        yield rec
    finally:
        npc_module._move = move


def npc_move_phase(dev, card, rows) -> int:
    """Phase 6b (see the module docstring); K2's row goes to ``rows``; 1 on
    failure."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.core.npc import move_ref
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.ops.npc_move_cases import CASES, case_args, on
    from marl_traffic_intersection_tpu_torch.ops.npc_move_cuda import npc_move
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    def held(args, label):
        """K2 once on ``args`` against move_ref on the card and on the CPU:
        the failures."""
        native.reset_launches()
        got = npc_move(*args)
        torch.cuda.synchronize()
        bad = [] if native.LAUNCHES["npc_move"] == 1 else [f"{label}: {dict(native.LAUNCHES)}"]
        for name, g, c, h in zip(("x", "y", "v", "heading", "steering_angle", "path_index"),
                                 got, move_ref(*args), move_ref(*on(args, "cpu"))):
            if not (bits_equal(g, c) and bits_equal(g, h)):
                bad.append(f"{label} {name}: {int((g.cpu() != h).sum())} of {g.numel()} differ")
        return bad

    row = rows["npc_move"] = dict(
        name="npc_move", route="cuda", source=SRC + "npc_move.cu",
        replaces="none: core/npc.py::move_ref's ~200 launches (the JAX package's "
                 "core/npc.py::_plan_npc_action, in XLA)",
        **kernel_regs(ptxas_info(native.build_log("npc_move.cu")), "npc_move_kernel"))
    bad = []
    for kind, width in CASES:
        bad += held(on(case_args(kind, width, NPC_MOVE_ENVS), dev), f"case {kind} w={width}")
    if bad:
        phase("npc_move", f"FAIL: {bad[:8]}")
        return 1
    phase("npc_move", f"K2 bit-equal to move_ref on the card and on the CPU, one launch a call, "
                      f"on {len(CASES)} seeded cases ({NPC_MOVE_ENVS} envs: dense and slot at "
                      f"w = 8, 16, 32, and the edge cases); {row['registers']} registers, "
                      f"{row['spill_stores']} B spilled, {row['stack_bytes']} B stack")

    # the traffic path's own arguments: config 4 at TRAFFIC_B x TRAFFIC_N, the
    # exact mode narrowed (w = 8), at w = 16 and at the full width
    rng = torch.Generator(device=dev).manual_seed(3)

    def actions():
        a = torch.rand((TRAFFIC_B, TRAFFIC_N, 2), generator=rng, device=dev)
        return torch.stack([a[..., 0] * 0.8 + 0.2, a[..., 1] * 0.4 - 0.2], -1)

    shapes = {}
    for tier in NPC_MOVE_TIERS:
        venv = VectorEnv(IntersectionEnv(EnvConfig(**TRAFFIC_CFG, npc_tier=tier), device=dev),
                         num_envs=TRAFFIC_B, seed=4)
        state, _ = venv.reset()
        for _ in range(100):
            state, _ = venv.step(state, actions())
        with moves_recorded() as rec:
            for _ in range(10):
                state, _ = venv.step(state, actions())
        for (S, M), args in rec.args.items():
            shapes.setdefault((S, M), args)
    for (S, M), args in sorted(shapes.items()):
        label = f"{'dense' if S == M else 'slot'} {TRAFFIC_B}x{S} M={M}"
        bad = held(args, label)
        if bad:
            phase("npc_move", f"FAIL on the traffic path's arguments: {bad}")
            return 1
        args_cpu = on(args, "cpu")
        bound, bound_by = k2_bound(TRAFFIC_B, S, M)
        ms = device_ms(lambda: npc_move(*args), 50, match="npc_move_kernel")
        plain = profile_steps(lambda: move_ref(*args), 5)
        t = dict(shape=label, ms=ms, event_ms=cuda_ms(lambda: npc_move(*args), 50),
                 plain_ms=plain["device_busy_ms_per_step"],
                 plain_launches=plain["kernel_launches_per_step"],
                 plain_host_ms=host_ms(lambda: move_ref(*args_cpu), 1),
                 bound_ms=bound, bound_by=bound_by)
        row.setdefault("shapes", []).append(t)
        phase("npc_move", f"{label} on the traffic path's arguments: bit-equal to move_ref on "
                          f"the card and on the CPU; K2 device {ms:.5f} ms (events, with the "
                          f"host, {t['event_ms']:.4f}); move_ref on the card "
                          f"{t['plain_ms']:.4f} ms device in {t['plain_launches']:.0f} launches, "
                          f"on the CPU {t['plain_host_ms']:.1f} ms; bound {bound:.5f} ms "
                          f"({bound_by}), share {bound / ms:.1%}; card {card}")
    if not {(8, 8), (16, 16), (32, 32)} <= set(shapes) or not any(S == 1 for S, _ in shapes):
        phase("npc_move", f"FAIL: the traffic path called _move at {sorted(shapes)}")
        return 1

    # the graphed traffic step: one K2 launch per replay of the dense plan's
    # segment and one per cleanup round
    venv = VectorEnv(IntersectionEnv(EnvConfig(**TRAFFIC_CFG), device=dev),
                     num_envs=TRAFFIC_B, seed=5)
    state, _ = venv.reset()
    gstep = venv.jit_step()
    for _ in range(50):
        state, _ = gstep(state, actions())
    stats = venv.env.npc_stats
    per_step = []
    for _ in range(40):
        native.reset_launches()
        rounds = stats["cleanup_rounds"]
        state, _ = gstep(state, actions())
        per_step.append((native.LAUNCHES["npc_move"], stats["cleanup_rounds"] - rounds))
    torch.cuda.synchronize()
    wrong = [(n, r) for n, r in per_step if n != 1 + r]
    row["launches_per_graphed_step"] = sum(n for n, _ in per_step) / len(per_step)
    row["cleanup_rounds_per_graphed_step"] = sum(r for _, r in per_step) / len(per_step)
    if wrong:
        phase("npc_move", f"FAIL: K2 launches against cleanup rounds per graphed step {wrong}")
        return 1
    phase("npc_move", f"graphed config-4 step, {TRAFFIC_B}x{TRAFFIC_N}, 40 steps after 50: K2 "
                      f"launches per step {row['launches_per_graphed_step']:.3f} = 1 + cleanup "
                      f"rounds {row['cleanup_rounds_per_graphed_step']:.3f} at every step; "
                      f"card {card}")
    return 0


def k3_bound(B, N, w):
    """K3's least time in ms, by bytes: each agent's state and actions read
    once (49 B) and its results written once (45 B), each env's counter read
    and its results written (14 B), its w NPC slots read once (13 B each),
    the route table read once (the path windows are in it). Its operations,
    ~1,500 an agent at N = 8 and w = 8 (the tick's transcendentals, 50
    distances, the status tests, separating-axis tests of ~110 each), take
    about as long at the f32 peak."""
    from marl_traffic_intersection_tpu_torch.core.constants import PATH_LEN

    routes = 144
    nbytes = B * N * (49 + 45) + B * (14 + 13 * w) + routes * (PATH_LEN * 8 + 28)
    return 1e3 * nbytes / HBM_BYTES_PER_S


@contextlib.contextmanager
def ticks_recorded():
    """core/env.py::ego_step wrapped while the block runs: ``.args`` keeps a
    copy of the last arguments by (B, N, w)."""
    from marl_traffic_intersection_tpu_torch.core import env as env_module
    from marl_traffic_intersection_tpu_torch.ops.ego_step_cases import NpcSlots

    tick = env_module.ego_step
    rec = types.SimpleNamespace(args={})

    def recorded(*args):
        ego, npc = args[0], args[5]
        slots = None if npc is None else NpcSlots(*(t.clone() for t in (npc.x, npc.y,
                                                                           npc.heading,
                                                                           npc.alive)))
        key = (*ego.x.shape, 0 if npc is None else npc.x.shape[1])
        rec.args[key] = (type(ego)(*(t.clone() for t in ego)), args[1].clone(), args[2],
                         args[3].clone(), args[4], slots, *args[6:])
        return tick(*args)

    env_module.ego_step = recorded
    try:
        yield rec
    finally:
        env_module.ego_step = tick


def ego_step_phase(dev, card, rows) -> int:
    """Phase 6c (see the module docstring); K3's row goes to ``rows``; 1 on
    failure."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.core import env as env_module
    from marl_traffic_intersection_tpu_torch.core.env import ego_step_ref
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.ops.ego_step_cases import (CASES, case_args, on,
                                                                        tick_bits)
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    def held(args, label):
        """K3 once on ``args`` against ego_step_ref on the card: the failures."""
        native.reset_launches()
        got = env_module.ego_step(*args)
        torch.cuda.synchronize()
        bad = [] if native.LAUNCHES["ego_step"] == 1 else [f"{label}: {dict(native.LAUNCHES)}"]
        for i, (g, w) in enumerate(zip(tick_bits(got), tick_bits(ego_step_ref(*args)))):
            if not torch.equal(g, w):
                bad.append(f"{label} output {i}: {int((g != w).sum())} of {g.numel()} differ")
        return bad

    row = rows["ego_step"] = dict(
        name="ego_step", route="cuda", source=SRC + "ego_step.cu",
        replaces="none: core/env.py::ego_step_ref's ~420-530 launches (the JAX package's "
                 "core/env.py step, in XLA)",
        **kernel_regs(ptxas_info(native.build_log("ego_step.cu")), "ego_step_kernel"))
    bad = []
    for name, envs in [(name, 64) for name in CASES] + [("n4", 4096), ("n8 w8", 4096),
                                                        ("n8 w16 team", 4096)]:
        bad += held(on(case_args(name, envs), dev), f"case {name} {envs} envs")
    if bad:
        phase("ego_step", f"FAIL: {bad[:8]}")
        return 1
    phase("ego_step", f"K3 bit-equal to ego_step_ref on the card, one launch a call, on "
                      f"{len(CASES) + 3} seeded cases; {row['registers']} registers, "
                      f"{row['spill_stores']} B spilled, {row['stack_bytes']} B stack")

    # the main path's own arguments: 4096 x 4 without NPCs, config 4 at
    # TRAFFIC_B x TRAFFIC_N narrowed (w = 8) and at npc_tier 16
    rng = torch.Generator(device=dev).manual_seed(3)

    def actions(n):
        a = torch.rand((TRAFFIC_B, n, 2), generator=rng, device=dev)
        return torch.stack([a[..., 0] * 0.8 + 0.2, a[..., 1] * 0.4 - 0.2], -1)

    shapes = {}
    for cfg, n in ((dict(num_agents=4), 4), (dict(TRAFFIC_CFG, npc_tier=-1), TRAFFIC_N),
                   (dict(TRAFFIC_CFG, npc_tier=16), TRAFFIC_N)):
        venv = VectorEnv(IntersectionEnv(EnvConfig(**cfg), device=dev), num_envs=TRAFFIC_B,
                         seed=4)
        state, _ = venv.reset()
        for _ in range(100):
            state, _ = venv.step(state, actions(n))
        with ticks_recorded() as rec:
            for _ in range(10):
                state, _ = venv.step(state, actions(n))
        shapes.update(rec.args)
    for (B, N, w), args in sorted(shapes.items()):
        label = f"{B}x{N} w={w}"
        bad = held(args, label)
        if bad:
            phase("ego_step", f"FAIL on the main path's arguments: {bad}")
            return 1
        ms = device_ms(lambda: env_module.ego_step(*args), 50, match="ego_step_kernel")
        plain = profile_steps(lambda: ego_step_ref(*args), 5)
        bound = k3_bound(B, N, w)
        t = dict(shape=label, ms=ms, event_ms=cuda_ms(lambda: env_module.ego_step(*args), 50),
                 plain_ms=plain["device_busy_ms_per_step"],
                 plain_launches=plain["kernel_launches_per_step"], bound_ms=bound,
                 bound_by="bytes")
        row.setdefault("shapes", []).append(t)
        phase("ego_step", f"{label} on the main path's arguments: bit-equal to ego_step_ref on "
                          f"the card; K3 device {ms:.5f} ms (events, with the host, "
                          f"{t['event_ms']:.4f}); ego_step_ref on the card {t['plain_ms']:.4f} "
                          f"ms device in {t['plain_launches']:.0f} launches; bound "
                          f"{bound:.5f} ms (bytes), share {bound / ms:.1%}; card {card}")
    if not {(TRAFFIC_B, 4, 0), (TRAFFIC_B, TRAFFIC_N, 8), (TRAFFIC_B, TRAFFIC_N, 16)} <= \
            set(shapes):
        phase("ego_step", f"FAIL: the main path called ego_step at {sorted(shapes)}")
        return 1

    # the graphed traffic step: one K3 launch per replay
    venv = VectorEnv(IntersectionEnv(EnvConfig(**TRAFFIC_CFG), device=dev),
                     num_envs=TRAFFIC_B, seed=5)
    state, _ = venv.reset()
    gstep = venv.jit_step()
    for _ in range(50):
        state, _ = gstep(state, actions(TRAFFIC_N))
    per_step = []
    for _ in range(40):
        native.reset_launches()
        state, _ = gstep(state, actions(TRAFFIC_N))
        per_step.append(native.LAUNCHES["ego_step"])
    torch.cuda.synchronize()
    row["launches_per_graphed_step"] = sum(per_step) / len(per_step)
    if per_step != [1] * 40:
        phase("ego_step", f"FAIL: K3 launches per graphed step {per_step}")
        return 1
    phase("ego_step", f"graphed config-4 step, {TRAFFIC_B}x{TRAFFIC_N}, 40 steps after 50: one "
                      f"K3 launch a step; card {card}")
    return 0


def traffic_phase(dev, card, kernels) -> int:
    """Phase 7 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import ActorCriticMLP

    B, N, STEPS = TRAFFIC_B, TRAFFIC_N, TRAFFIC_STEPS
    torch.manual_seed(0)
    model = ActorCriticMLP().to(dev)
    with torch.no_grad():
        # a cruise bias on the throttle mean (tanh(1) = 0.76): the seeded
        # policy alone idles at the spawn points, and an ego there blocks
        # every NPC spawn near it
        model.pi_mean.bias[0] += 1.0
    # the exact mode narrowed to the live slot prefix (npc_tier=-1, the
    # default) and at the full width (npc_tier=0), in turns, on the same
    # resets, spawns and actions; the second pair runs a quarter as many steps
    runs, PAIR2 = [], STEPS // 4
    for turn, tier in enumerate((-1, 0, 0, -1)):
        label = f"exact {'narrowed (npc_tier=-1)' if tier else 'full width (npc_tier=0)'}"
        r = traffic_run(dev, card, kernels, model, f"{label}, turn {turn + 1}",
                        STEPS if turn < 2 else PAIR2, profile=turn < 2, time_libm=turn == 0,
                        npc_tier=tier)
        if r is None:
            return 1
        runs.append(r)
        torch.cuda.empty_cache()
    narrow, full = runs[0], runs[1]
    differ = [(j, i) for j in (0, 2)
              for i, (a, b) in enumerate(zip(runs[j]["final"], runs[j + 1]["final"]))
              if not bits_equal(a, b)]
    small = [m for m in narrow["by_m"] if m < N + 32]
    if differ or full["by_m"] != {N + 32: STEPS} or not small:
        phase("traffic", f"FAIL: narrowed vs full width: final states differ in (first "
                         f"turn of the pair, tensor) {differ[:5]}; K1 by M narrowed "
                         f"{narrow['by_m']}, full "
                         f"{full['by_m']}")
        return 1
    rates = [round(r["rate"], 1) for r in runs]
    phase("traffic", f"narrowed vs full width, exact, in turns (narrowed, full: {STEPS} "
                     f"steps; full, narrowed: {PAIR2}): final states bit-equal within "
                     f"each pair ({len(narrow['final'])} tensors each); "
                     f"env-steps/s {rates}; peak MiB {[round(r['peak'] / 2**20, 1) for r in runs]}"
                     f"; device reads per step {[round(r['reads'], 3) for r in runs]}; card {card}")
    for k in kernels:
        kernels[k]["launches_traffic"] = narrow["launches"].get(k, 0)
        kernels[k]["launches_traffic_full"] = full["launches"].get(k, 0)
    kernels["lidar_scan"]["launches_traffic_by_m"] = narrow["by_m"]

    # the fast NPC mode, and the density of test.py's traffic (10) after 150
    # steps, when the egos have cleared the spawn points and the pool has
    # grown to its steady size (on the CPU at 32 envs: mean 4-5 alive, 6-7
    # at most)
    for label, steps, cfg in (("fast narrowed", 100, dict(npc_mode="fast")),
                              ("exact narrowed, density 10", 50,
                               dict(traffic_density=10.0, warmup=150))):
        r = traffic_run(dev, card, kernels, model, label, steps, profile=True, **cfg)
        if r is None:
            return 1
        runs.append(r)
        torch.cuda.empty_cache()
    dense = runs[-1]
    kernels["lidar_scan"]["launches_traffic_density10_by_m"] = dense["by_m"]

    # K1 on the last obstacle set of each M in each run above, against its
    # plain version; timed on the first run's set of each M (M = 16 and 40 on
    # the same poses, those of the first pair's final states)
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.ops import lidar_cuda
    timed = set()
    for r in runs:
        for M, args in sorted(r["k1_args"].items()):
            got = lidar_cuda.lidar_scan(*args)
            ref, samples = lidar_scan_ref(*args, return_samples=True)
            if not bits_equal(got, ref):
                diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
                phase("traffic", f"FAIL: K1 differs from lidar_scan_ref on {diff} rays at M={M}")
                return 1
            if M in timed:
                continue
            timed.add(M)
            tag = "traffic" if M == N + 32 else f"traffic_m{M}"
            warps = samples.reshape(-1, 32).double()
            k = kernels["lidar_scan"]
            k.update({f"max_abs_err_{tag}": float((got - ref).abs().max()),
                      f"lane_efficiency_{tag}": float(warps.sum()
                                                      / (32 * warps.max(1).values).sum()),
                      f"blocks_per_sm_{tag}": lidar_cuda.blocks_per_sm(M)})
            phase("traffic", f"K1 {B}x{N} M={M} ({tag}): bit-equal to the plain version "
                             f"({got.numel()} rays, {int(samples.sum())} samples marched, "
                             f"{int(args[6].sum())} obstacles present); "
                             f"{k1_times(args, kernels, tag)}; lane efficiency "
                             f"{k[f'lane_efficiency_{tag}']:.4f}, {k[f'blocks_per_sm_{tag}']} "
                             f"blocks per SM; card {card}")
    phase("traffic", f"K1 bit-equal to its plain version on the last obstacle set of each "
                     f"M of each of the {len(runs)} runs: M by run "
                     f"{[sorted(r['k1_args']) for r in runs]}")

    # the graphed step (jit_step) against the eager one, in turns
    for label, cfg in (("exact narrowed", dict(replay_times=True)),
                       ("exact full width (npc_tier=0)", dict(npc_tier=0)),
                       ("fast narrowed", dict(npc_mode="fast")),
                       ("exact narrowed, density 10", dict(traffic_density=10.0, warmup=150))):
        if traffic_turns(dev, card, kernels, model, label, **cfg) is None:
            return 1
        torch.cuda.empty_cache()

    # 64 x 8 x 200 with injected spawns: card = CPU, and slot = wave = serial
    modes = (("exact", "slot"), ("exact", "wave"), ("serial", "slot"))
    cpu, _, _ = traffic_runs("cpu", modes[:1])
    card_runs, alive_steps, loops = traffic_runs(dev, modes)
    ref = cpu[modes[0]]
    for key, hist in card_runs.items():
        bad = [i for i, (a, b) in enumerate(zip(ref, hist)) if not bits_equal(a, b)]
        if bad or len(hist) != len(ref):
            phase("traffic", f"FAIL: the card's {key} run differs from the CPU's exact run in "
                             f"{len(bad)} tensors, first #{bad[:1]}")
            return 1
    # the exact runs must have replayed dependent slots and run the cascade,
    # else slot = wave = serial would rest on the dense pass alone
    idle = [k for k in modes[:2] if not (loops[k].get("cleanup_rounds", 0) > 0
                                         and loops[k].get("collision_rounds", 0) > 0)]
    if alive_steps < 64 * TRY_STEPS or idle:
        phase("traffic", f"FAIL: {alive_steps} NPC-steps in the 64-env run (want one per "
                         f"env-step or more); loop rounds {loops}")
        return 1
    phase("traffic", f"64x8, {TRY_STEPS} steps, injected spawns: the card's exact slot, exact "
                     f"wave and serial runs bit-equal to the CPU's exact run ({len(ref)} tensors "
                     f"each; {alive_steps} NPC-steps); the card's loop rounds, device reads and "
                     f"seconds by run {loops}")

    # the train entry point with traffic: 3 updates, then one by auto-resume
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--num-envs", str(TRAIN_B), "--agents", str(TRAIN_N), "--rollout-len",
                str(TRAIN_T), "--log-every", "1", "--traffic", "--density", "1.0",
                "--checkpoint", os.path.join(tmp, "run")]
        torch.cuda.reset_peak_memory_stats()
        with k1_counted() as rec:
            logs, _ = run_train(argv + ["--updates", "3"])
            resumed, _ = run_train(argv + ["--updates", "4"])
        peak = torch.cuda.max_memory_allocated()
        saved = restore_checkpoint(argv[-1])
        held, bad = held_seen(rec, kernels)
        if (len(logs) != 3 or not losses_finite(logs) or [ln["update"] for ln in resumed] != [3]
                or not losses_finite(resumed) or saved["update"] != 4
                or int(saved["env_state"]["npc.next_uid"].sum()) == 0 or bad
                or any(ln["step"] != "graphed" for ln in logs + resumed)):
            phase("traffic", f"FAIL: train --traffic logged {logs} then {resumed}; saved update "
                             f"{saved['update']}; {bad}")
            return 1
    phase("traffic", f"train --traffic --density 1.0, {TRAIN_B}x{TRAIN_N}, rollout {TRAIN_T}: "
                     f"env-steps/s by update {[ln['env_steps_per_s'] for ln in logs + resumed]}, "
                     f"rollout s {[ln['rollout_s'] for ln in logs + resumed]}, update s "
                     f"{[ln['update_s'] for ln in logs + resumed]}; step "
                     f"{[ln['step'] for ln in logs + resumed]}; peak memory "
                     f"{peak / 2**20:.1f} MiB; the kernels on the last step's operands bit-equal "
                     f"to their plain versions: {held}; card {card}")

    # the graphed PPO step with traffic against train's eager one: the first
    # rollout bit-equal, the host's reads and rounds equal
    t0 = time.perf_counter()
    runs = ppo_runs(dev, TRAIN_B, TRAIN_T, {}, ("host adam", "graphed"), profile=False,
                    traffic_flow=True, traffic_density=1.0)
    g, h = runs["graphed"], runs["host adam"]
    bad_first = int(leaf_mismatches(g["trajs"][0], h["trajs"][0]))
    stats = [r["after"][0]["npc_stats"] for r in (h, g)]
    msg = (f"PPO --traffic --density 1.0, {TRAIN_B}x{TRAIN_N}, rollout {TRAIN_T}, bf16 MLP: the "
           f"graphed train step's first rollout against train's eager step: {bad_first} "
           f"elements differ; the first rollout's npc_stats eager {stats[0]}, graphed "
           f"{stats[1]}")
    if bad_first or stats[0] != stats[1] or not stats[0].get("tier_reads"):
        phase("traffic", "FAIL: " + msg)
        return 1
    phase("traffic", msg + "; rollout_s/update_s by update: " + "; ".join(
        f"{name} {[(round(x['rollout_s'], 4), round(x['update_s'], 4)) for x in r['splits']]}"
        for name, r in runs.items()) + f"; {len(g['graphs'])} graphs, capture "
        f"{sum(v.capture_s for v in g['graphs'].values()):.3f} s; "
        f"{time.perf_counter() - t0:.1f} s; card {card}")
    return 0

# the shipped policies: export name -> model family; README:231-240's mean
# episode lengths on config 1
SHIPPED = {"policy_mlp_cfg1": "mlp", "policy_mlp_multi": "mlp",
           "policy_attn_cfg1": "attention", "policy_attn_multi": "attention",
           "policy_conv_cfg1": "conv", "policy_conv_multi": "conv",
           "policy_gru_cfg1": "gru", "policy_gru_multi": "gru",
           "policy_central_cfg4": "central", "policy_central_multi": "central",
           "policy_sac_cfg1": "sac", "policy_sac_multi": "sac"}
README_EP_LEN = {"policy_mlp_cfg1": 71, "policy_attn_cfg1": 73, "policy_conv_cfg1": 68,
                 "policy_gru_cfg1": 73, "policy_sac_cfg1": 78}
# tests/test_torch_artifacts.py: bf16 outputs within 2^-5 of their largest
# magnitude (the GRU's means at every step of a 16-step sequence), float32
# ones within 1e-5 of it
BF16_REL = 2.0 ** -5
F32_REL = 1e-5
# the GRU's hidden state (|h| < 1), card vs CPU over 16 steps: in bf16 each
# step's rounding differences are carried on by the recurrence, so the bound
# is twice the largest reading on an H100 (0.04297; 0.0176-0.0312 over these
# 6 seeds, PERF.md); in float32 it is the outputs' 1e-5
GRU_H_BF16 = 0.086
GRU_SEEDS = range(11, 17)


def padded_forward(act, obs, h, max_batch, dev):
    """The answer of a direct forward on the card over ``obs`` (and ``h``)
    cut into max_batch-row chunks, each zero-padded: (actions, h_new)."""
    acts, hs = [], []
    for i in range(0, len(obs), max_batch):
        n = len(obs[i:i + max_batch])
        po = torch.zeros((max_batch, 127), device=dev)
        po[:n] = torch.from_numpy(obs[i:i + max_batch])
        ph = None
        if act.h_dim:
            ph = torch.zeros((max_batch, act.h_dim), device=dev)
            if h is not None:
                ph[:n] = torch.from_numpy(h[i:i + max_batch])
        a, h_new = act.forward(po, ph)
        acts.append(a[:n].cpu().numpy())
        if h_new is not None:
            hs.append(h_new[:n].cpu().numpy())
    return np.concatenate(acts), (np.concatenate(hs) if hs else None)


def gru_drift(gm, cm, seq, dev) -> tuple:
    """The GRU ``gm`` on the card and ``cm`` on the CPU over the steps of
    ``seq`` (T, B, 127), both from zero hidden states: the largest difference
    of the means relative to the largest mean, and the largest difference of
    the hidden states, over all steps."""
    hg, hc = gm.initial_hidden(seq.shape[1], device=dev), cm.initial_hidden(seq.shape[1])
    err = h_err = 0.0
    with torch.no_grad():
        for o in seq:
            mg, _, _, hg = gm(torch.from_numpy(o).to(dev), hg)
            mc, _, _, hc = cm(torch.from_numpy(o), hc)
            err = max(err, float((mg.cpu() - mc).abs().max()) / max(1.0, float(mc.abs().max())))
            h_err = max(h_err, float((hg.cpu() - hc).abs().max()))
    return err, h_err


def policies_phase(dev, card, kernels) -> int:
    """Phase 8 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import evaluate, serve
    from marl_traffic_intersection_tpu_torch.convert import params_from_flax
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import (EXPORTS, load_policy,
                                                                      read_export)

    # ---- every export onto the card; each family's forward, card vs CPU
    rng = np.random.RandomState(11)
    obs = rng.uniform(-1, 1, (4096, 127)).astype(np.float32)
    t0 = time.perf_counter()
    worst, h_drift = {}, {}
    for name, kind in SHIPPED.items():
        (gm, gfn), (cm, cfn) = load_policy(name, kind, dev), load_policy(name, kind, "cpu")
        if next(gm.parameters()).device != torch.device(dev):
            phase("policies", f"FAIL: {name} did not load onto the card")
            return 1
        if kind == "gru":
            # bf16 as loaded, over several seeded 16-step sequences, then float32
            err, h_drift[name] = 0.0, []
            for s in GRU_SEEDS:
                seq = np.random.RandomState(s).uniform(-1, 1, (16, 4096, 127)).astype(np.float32)
                e, h = gru_drift(gm, cm, seq, dev)
                err = max(err, e)
                h_drift[name].append(round(h, 6))
            f32 = [params_from_flax(kind, read_export(EXPORTS / f"{name}.npz")["params"],
                                    make_model(kind, compute_dtype=torch.float32))
                   for _ in range(2)]
            e32, h32 = gru_drift(f32[0].to(dev).eval(), f32[1].eval(), seq, dev)
            worst[f"{name} float32 mean, h"] = (float(f"{e32:.4g}"), float(f"{h32:.4g}"))
            if max(h_drift[name]) > GRU_H_BF16 or e32 > F32_REL or h32 > F32_REL:
                phase("policies", f"FAIL: {name}: card vs CPU hidden states part by up to "
                                  f"{h_drift[name]} in bf16 by seed (tolerance {GRU_H_BF16}); "
                                  f"float32 means by {e32:.4g} of the largest and hidden "
                                  f"states by {h32:.4g} (tolerance {F32_REL})")
                return 1
        else:
            o = obs.reshape(1024, 4, 127) if kind == "central" else obs
            mg, mc = gfn(torch.from_numpy(o).to(dev)).cpu(), cfn(torch.from_numpy(o))
            err = float((mg - mc).abs().max() / max(1.0, float(mc.abs().max())))
        worst[name] = round(err, 6)
        if not err <= BF16_REL:
            phase("policies", f"FAIL: {name}: card and CPU means part by {err:.4g} of the "
                              f"largest (tolerance {BF16_REL})")
            return 1
    phase("policies", f"12 exports loaded onto the card; card vs CPU means on 4096 seeded "
                      f"observations (the GRU over 16 steps of {len(GRU_SEEDS)} seeds), largest "
                      f"difference relative to the largest mean (tolerance {BF16_REL}; float32 "
                      f"{F32_REL}): {worst}; the GRU's largest bf16 hidden-state difference by "
                      f"seed (tolerance {GRU_H_BF16}): {h_drift}; "
                      f"{time.perf_counter() - t0:.1f} s")

    # ---- config 1 with each *_cfg1 policy
    def run_eval(argv):
        lines = json_lines(evaluate.main, argv, "policies")
        return lines[-1]

    for name, want_len in README_EP_LEN.items():
        with k1_counted() as rec:
            got = run_eval(["--config", "1", "--vector", "1024", "--max-steps", "200",
                            "--policy", "checkpoint", "--checkpoint", f"artifacts/{name}",
                            "--model", SHIPPED[name]])
        held, bad = held_to_plain(rec, kernels)
        ok = (got["success_rate_per_episode"] == 1.0 and got["crashes_vehicle"] == 0
              and got["crashes_object"] == 0)
        phase("policies", f"config 1, {name}: {got['episodes']} episodes, success rate "
                          f"{got['success_rate_per_episode']}, crashes "
                          f"{got['crashes_vehicle']} + {got['crashes_object']}, mean episode "
                          f"length {got['mean_ep_len']} (README {want_len}), "
                          f"{got['env_steps_per_s']} env-steps/s; the kernels on the last "
                          f"step's operands bit-equal to their plain versions: {held}; card {card}")
        if not ok or bad:
            phase("policies", f"FAIL: {name} on config 1: {got}; {bad}")
            return 1

    # ---- config 4 (8 agents, traffic): K1 once per step, at M = 8 + w for
    # the widths w of the NPC pool that ran (8, 16 narrowed, 32 full)
    for name in ("policy_attn_multi", "policy_gru_multi", "policy_central_cfg4",
                 "policy_sac_multi"):
        native.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with k1_counted() as k1:
            got = run_eval(["--config", "4", "--vector", "4096", "--max-steps", "200",
                            "--policy", "checkpoint", "--checkpoint", f"artifacts/{name}",
                            "--model", SHIPPED[name]])
        launches = dict(native.LAUNCHES)
        held, bad = held_to_plain(k1, {k: v for k, v in kernels.items() if launches.get(k)})
        phase("policies", f"config 4, {name}, 4096 x 8, 200 exact steps: completions "
                          f"{got['successes']}, crashes {got['crashes_vehicle']} vehicle + "
                          f"{got['crashes_object']} object in {got['episodes']} episodes, "
                          f"mean episode reward {got['mean_ep_reward']}, "
                          f"{got['env_steps_per_s']} env-steps/s, K1 launches by M "
                          f"{dict(k1.by_m)}, the kernels on the last step's operands (K1 at "
                          f"each M) bit-equal to their plain versions: {held}, peak memory "
                          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card}")
        if not np.isfinite(got["mean_ep_reward"]) or sum(k1.by_m.values()) != 200 \
                or not set(k1.by_m) <= {16, 24, 40} or launches.get("lidar_scan", 0) != 200 \
                or bad:
            phase("policies", f"FAIL: {name} on config 4: {got}, launches {launches}; {bad}")
            return 1
        if name == "policy_gru_multi":
            missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
            if missing:
                phase("policies", f"FAIL: kernels not launched in evaluate: {missing}")
                return 1
            for k in kernels:
                kernels[k]["launches_eval_config4"] = launches.get(k, 0)

    # ---- serve on a free local port, answers against a direct padded forward
    def post(port, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        return body, (time.perf_counter() - t) * 1e3

    for name in ("policy_mlp_multi", "policy_gru_multi"):
        act = serve.make_policy(name, SHIPPED[name], 256, dev)
        port = free_port()
        httpd = serve.make_server(act, port)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            rows = [rng.uniform(-1, 1, (n, 127)).astype(np.float32) for n in (1, 300, 300)]
            answers, h_prev = [], None
            for i, o in enumerate(rows):
                h = h_prev if (i == 2 and act.h_dim) else None
                if i == 2 and not act.h_dim:
                    o = o[:256]
                payload = {"obs": o.tolist(), **({"h": h.tolist()} if h is not None else {})}
                body, ms = post(port, payload)
                got_a = np.asarray(body["actions"], np.float32)
                got_h = np.asarray(body["h"], np.float32) if act.h_dim else None
                want_a, want_h = padded_forward(act, o, h, 256, dev)
                same = got_a.shape == want_a.shape and np.array_equal(
                    got_a.view(np.int32), want_a.view(np.int32))
                if act.h_dim:
                    same = same and np.array_equal(got_h.view(np.int32),
                                                   want_h.view(np.int32))
                answers.append((len(o), h is not None, round(ms, 3), same))
                h_prev = got_h
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
        phase("policies", f"serve {name} (max_batch 256): (rows, with h, ms, bit-equal to a "
                          f"direct padded forward) {answers}; card {card}")
        if not all(a[3] for a in answers) or th.is_alive():
            phase("policies", f"FAIL: serve {name}: {answers}")
            return 1
    return 0


def free_port() -> int:
    """A free local TCP port."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def learners_phase(dev, card, kernels) -> int:
    """Phase 9 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import train_sac
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint

    B, N, T = TRAIN_B, TRAIN_N, TRAIN_T
    size = ["--num-envs", str(B), "--agents", str(N), "--rollout-len", str(T), "--log-every", "1",
            "--model", "gru"]
    # ---- train --model gru at 4096 x 4: 3 updates, then one by auto-resume
    with tempfile.TemporaryDirectory() as tmp:
        argv = size + ["--checkpoint", os.path.join(tmp, "run")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        logs, _ = run_train(argv + ["--updates", "3"], "learners")
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        resumed, prof = run_train(argv + ["--updates", "4", "--profile",
                                          os.path.join(TRACES, "train_gru.json.gz")], "learners")
        saved = restore_checkpoint(argv[-1])
    k1 = launches.get("lidar_scan", 0)
    if (len(logs) != 3 or not losses_finite(logs) or k1 != 3 * T
            or [ln["update"] for ln in resumed] != [3] or not losses_finite(resumed)
            or saved["update_count"] != 16 or tuple(saved["h"].shape) != (B, N, 128)):
        phase("learners", f"FAIL: train --model gru logged {len(logs)} + {len(resumed)} lines, "
                          f"K1 launched {k1} times (want {3 * T}), saved update_count "
                          f"{saved['update_count']}")
        return 1
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    if missing:
        phase("learners", f"FAIL: kernels not launched in GRU training: {missing}")
        return 1
    for k in kernels:
        kernels[k]["launches_gru_train"] = launches.get(k, 0)
    split_line("gru", logs + resumed, prof, peak, card, "learners")
    phase("learners", f"gru: 3 updates + 1 auto-resumed, finite losses, K1 launched {k1} times "
                      f"in the 3; launches {launches}")

    # ---- train_sac at its defaults, seeded by a shipped policy's demos
    native.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with k1_counted() as rec:
        lines = json_lines(train_sac.main, ["--calls", "40", "--demo",
                                            "artifacts/policy_mlp_multi", "--demo-steps", "16"],
                           "learners")
    launches = dict(native.LAUNCHES)
    held, bad = held_to_plain(rec, kernels)
    if bad:
        phase("learners", f"FAIL: train_sac 256 x 2: {bad}")
        return 1
    demo, logs = lines[0], [ln for ln in lines if "call" in ln]
    keys = ("q_loss", "actor_loss", "alpha", "mean_q", "entropy", "mean_reward")
    finite = bool(logs) and all(np.isfinite([ln[k] for k in keys]).all() for ln in logs)
    k1 = launches.get("lidar_scan", 0)
    if (demo.get("demo_transitions") != 16 * 256 * 2 or not finite or logs[-1]["updates"] != 320
            or logs[-1]["alpha"] == 0.2 or k1 != 16 + 40 * 8):
        phase("learners", f"FAIL: train_sac: demo {demo}, last log {logs[-1:]}, K1 launched "
                          f"{k1} times (want {16 + 40 * 8})")
        return 1
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    if missing:
        phase("learners", f"FAIL: kernels not launched in SAC training: {missing}")
        return 1
    for k in kernels:
        kernels[k]["launches_sac_train"] = launches.get(k, 0)
    phase("learners", f"train_sac 256 x 2, 40 calls after {demo['demo_transitions']} demo "
                      f"transitions: env-steps/s by log {[ln['env_steps_per_s'] for ln in logs]}, "
                      f"alpha {logs[-1]['alpha']}, buffer {logs[-1]['buffer_size']}, K1 launched "
                      f"{k1} times, by M {dict(rec.by_m)}; the kernels on the last step's "
                      f"operands bit-equal to their plain versions: {held}; peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card}")
    torch.cuda.reset_peak_memory_stats()
    lines = json_lines(train_sac.main, ["--num-envs", "4096", "--agents", "4", "--calls", "8"],
                       "learners")
    logs = [ln for ln in lines if "call" in ln]
    if not logs or not all(np.isfinite([ln[k] for k in keys]).all() for ln in logs):
        phase("learners", f"FAIL: train_sac 4096 x 4: {logs}")
        return 1
    phase("learners", f"train_sac 4096 x 4, 8 calls: env-steps/s {logs[-1]['env_steps_per_s']} "
                      f"(calls 1-7), peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
                      f"MiB; card {card}")
    return card_vs_cpu_learners(dev)


def card_vs_cpu_learners(dev) -> int:
    """One recurrent-PPO update and 8 SAC updates of fixed 64 x 4 x 16 CPU
    trajectories on the card and on the CPU in float32, their permutations,
    indices and noise injected: parameters within 1e-5, Adam's moments within
    1e-4 of their largest, the updates moving the parameters more than ten
    times that."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.models.recurrent import RecurrentActorCritic
    from marl_traffic_intersection_tpu_torch.models.sac import SquashedGaussianActor, TwinQCritic
    from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig
    from marl_traffic_intersection_tpu_torch.parallel.recurrent_ppo import (RecTransition,
                                                                            RecurrentPPOLearner)
    from marl_traffic_intersection_tpu_torch.parallel.sac import SACConfig, SACLearner

    PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4
    f32 = dict(compute_dtype=torch.float32)

    def venv_on(d):
        return VectorEnv(IntersectionEnv(EnvConfig(num_agents=4), device=d), num_envs=64, seed=3)

    def seeded(make):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            return make()

    def compare(name, models, opts, fresh):
        """models/opts: {device: [modules]}, {device: [optimizers]}."""
        cpu, gpu = models["cpu"], models[str(dev)]
        pairs = [(a, b) for m, n in zip(cpu, gpu) for a, b in zip(m.parameters(), n.parameters())]
        diff = max(float((a.detach() - b.detach().cpu()).abs().max()) for a, b in pairs)
        mdiff = 0.0
        for oc, og in zip(opts["cpu"], opts[str(dev)]):
            for pc, pg in zip([p for g in oc.param_groups for p in g["params"]],
                              [p for g in og.param_groups for p in g["params"]]):
                for k in ("exp_avg", "exp_avg_sq"):
                    a, b = oc.state[pc][k], og.state[pg][k].cpu()
                    mdiff = max(mdiff, float((a - b).abs().max() / max(a.abs().max(), 1e-30)))
        moved = max(float((a.detach() - f.detach()).abs().max())
                    for m, fm in zip(cpu, fresh) for a, f in zip(m.parameters(), fm.parameters()))
        msg = (f"{name}: card vs CPU parameters within {diff:.3g} (tolerance {PARAM_TOL}), Adam "
               f"moments within {mdiff:.3g} of their largest (tolerance {MOMENT_TOL}); the "
               f"updates moved the parameters up to {moved:.3g}")
        ok = diff <= PARAM_TOL and mdiff <= MOMENT_TOL and moved > 10 * PARAM_TOL
        phase("learners", ("" if ok else "FAIL: ") + msg)
        return ok

    # recurrent PPO: one update of a CPU trajectory
    cfg = PPOConfig(rollout_len=16)
    g = torch.Generator().manual_seed(9)
    perms = [torch.randperm(cfg.num_minibatches, generator=g) for _ in range(cfg.update_epochs)]
    models, opts = {}, {}
    for d in ("cpu", dev):
        queue = [p.to(d) for p in perms]
        lrn = RecurrentPPOLearner(venv_on(d), seeded(lambda: RecurrentActorCritic(**f32)), cfg,
                                  seed=4, perm_fn=lambda n, q=queue: q.pop(0))
        ts = lrn.init()
        if d == "cpu":
            s0, o0 = lrn.env.reset()
            _, _, _, traj_cpu, lv = lrn.rollout(ts, s0, o0, lrn.initial_hidden())
            advs, rets = lrn._gae(traj_cpu, lv)
        ts, _ = lrn.update(ts, RecTransition(*(t.to(d) for t in traj_cpu)), advs.to(d),
                           rets.to(d))
        models[str(d)], opts[str(d)] = [ts.model], [ts.optimizer]
    if not compare("recurrent PPO, 64x4x16, one update (16 Adam steps)", models, opts,
                   [seeded(lambda: RecurrentActorCritic(**f32))]):
        return 1

    # SAC: 8 updates from a ring of 64 x 4 x 16 CPU transitions
    scfg = SACConfig(batch_size=256, buffer_capacity=64 * 4 * 16, warmup=0)
    g = torch.Generator().manual_seed(10)
    draws = [(torch.randint(0, 64 * 4 * 16, (256,), generator=g),
              torch.randn(256, 2, generator=g), torch.randn(256, 2, generator=g))
             for _ in range(8)]
    nets = lambda: (SquashedGaussianActor(**f32), TwinQCritic(**f32))
    models, opts = {}, {}
    for d in ("cpu", dev):
        idx = [i.to(d) for i, _, _ in draws]
        noise = [n.to(d) for _, a, b in draws for n in (a, b)]
        lrn = SACLearner(venv_on(d), scfg, *seeded(nets), seed=4,
                         noise_fn=lambda shape, q=noise: q.pop(0),
                         index_fn=lambda n, size, q=idx: q.pop(0))
        ts = lrn.init()
        if d == "cpu":
            s0, o0 = lrn.env.reset()
            gen = torch.Generator().manual_seed(12)
            rand = lambda o: torch.rand(o.shape[:-1] + (2,), generator=gen) * 2 - 1
            lrn.collect(ts, s0, o0, rand, 16)
            ring = ts.buffer
        else:
            for k in ("obs", "action", "reward", "next_obs", "done"):
                getattr(ts.buffer, k).copy_(getattr(ring, k))
            ts.buffer.size.fill_(int(ring.size))
        for _ in range(8):
            lrn._update(ts)
        models[str(d)] = [ts.actor, ts.critic, ts.critic_target]
        opts[str(d)] = [ts.actor_opt, ts.q_opt, ts.alpha_opt]
    fresh = list(seeded(nets))
    fresh.append(fresh[1])
    if not compare("SAC, a 64x4x16 ring, 8 updates", models, opts, fresh):
        return 1
    return 0


def resume_phase(dev, card, kernels) -> int:
    """Phase 10 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch import warm_start_central
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.ops import native
    from marl_traffic_intersection_tpu_torch.parallel.ppo import (PPOConfig, PPOLearner,
                                                                  TrainState, Transition)
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import (load_train_state,
                                                                      restore_checkpoint)

    store = load_train_state("policy_attn_cfg1", "attention")
    count = int(next(iter(store.optimizer.state.values()))["step"])
    T = 64                                   # train's default rollout
    with tempfile.TemporaryDirectory() as tmp:
        # the fine-tune recipe that made policy_attn_multi, at train's default width
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        logs, _ = run_train(["--model", "attention", "--resume", "policy_attn_cfg1",
                             "--agents", "4", "--ent-coef", "0.001", "--lr", "1e-4",
                             "--updates", "2", "--log-every", "1",
                             "--checkpoint", os.path.join(tmp, "attn")], "resume")
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        saved = restore_checkpoint(os.path.join(tmp, "attn"))
        steps = {int(st["step"]) for st in saved["optimizer"]["state"].values()}
        if ([ln["update"] for ln in logs] != [store.update, store.update + 1]
                or not losses_finite(logs) or saved["update"] != store.update + 2
                or saved["update_count"] != 32 or steps != {count + 32}
                or launches.get("lidar_scan", 0) != 2 * T):
            phase("resume", f"FAIL: the attention fine-tune logged {logs}, saved update "
                            f"{saved['update']} count {saved['update_count']}, Adam steps "
                            f"{steps} (want {count + 32}), K1 launched "
                            f"{launches.get('lidar_scan', 0)} times (want {2 * T})")
            return 1
        missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
        if missing:
            phase("resume", f"FAIL: kernels not launched in the fine-tune: {missing}")
            return 1
        for k in kernels:
            kernels[k]["launches_resume"] = launches.get(k, 0)
        roll = [ln["rollout_s"] for ln in logs]
        upd = [ln["update_s"] for ln in logs]
        phase("resume", f"train --model attention --resume policy_attn_cfg1 --agents 4 "
                        f"--ent-coef 0.001 --lr 1e-4, 1024 x 4, rollout {T}: the first update "
                        f"is {logs[0]['update']} (the store's update) with Adam at step "
                        f"{count} (the store's count); rollout s {roll}, update s {upd}; "
                        f"env-steps/s by update {[ln['env_steps_per_s'] for ln in logs]} (the "
                        f"second: {1024 * T / (roll[1] + upd[1]):.1f} from the split); peak "
                        f"memory {peak / 2**20:.1f} MiB; launches {launches}; card {card}")

        # MAPPO from the trained mlp: the transplant, then the warm-up resume
        out = os.path.join(tmp, "central_warm")
        json_lines(warm_start_central.main, ["--source", "policy_mlp_cfg1", "--out", out,
                                             "--agents", "4"], "resume")
        logs, _ = run_train(["--model", "central", "--resume", out, "--critic-warmup", "1",
                             "--updates", "2", "--log-every", "1"], "resume")
        if [ln["update"] for ln in logs] != [0, 1] or not losses_finite(logs) \
                or abs(logs[0]["approx_kl"]) > 1e-4:
            phase("resume", f"FAIL: train --model central from the warm start logged {logs}")
            return 1
        phase("resume", f"warm_start_central then train --model central --critic-warmup 1: "
                        f"approx_kl by update {[ln['approx_kl'] for ln in logs]} (the actor "
                        f"held on the first), env-steps/s "
                        f"{[ln['env_steps_per_s'] for ln in logs]}")

    # one float32 update resumed from policy_mlp_cfg1 on a fixed config-1
    # CPU trajectory (the observations the store was trained on: its weights
    # on the neighbour slots have a zero second moment, tests/test_torch_resume.py),
    # on the CPU and on the card
    PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4
    cfg16 = PPOConfig(rollout_len=16)
    g = torch.Generator().manual_seed(9)
    perms = [torch.randperm(16, generator=g) for _ in range(cfg16.update_epochs)]
    f32 = dict(compute_dtype=torch.float32)
    one = EnvConfig(num_agents=1)
    updated = {}
    for d in ("cpu", dev):
        st = load_train_state("policy_mlp_cfg1", "mlp", model=make_model("mlp", **f32).to(d))
        queue = [p.to(d) for p in perms]
        env = IntersectionEnv(one, device=d)
        ven = VectorEnv(env, num_envs=64, seed=3,
                        route_pool=env.table.route_ids([("IN_6", "OUT_2")]))
        lrn = PPOLearner(ven, st.model, cfg16, seed=4, perm_fn=lambda n, q=queue: q.pop(0))
        ts = TrainState(st.model, st.optimizer, 0)
        start = int(next(iter(st.optimizer.state.values()))["step"])
        if d == "cpu":
            s0, o0 = ven.reset()
            _, _, traj_cpu, lv = lrn.rollout(ts, s0, o0)
            advs_cpu, rets_cpu = lrn._gae(traj_cpu, lv)
            before = {k: v.detach().clone() for k, v in ts.model.named_parameters()}
        ts, _ = lrn.update(ts, Transition(*(t.to(d) for t in traj_cpu)), advs_cpu.to(d),
                           rets_cpu.to(d))
        opt = ts.optimizer.state
        updated[str(d)] = {k: [v.detach().cpu()] + [opt[v][m].cpu() for m in ("exp_avg",
                                                                               "exp_avg_sq")]
                           for k, v in ts.model.named_parameters()}
    cpu, gpu = updated["cpu"], updated[str(dev)]
    diff = max(float((cpu[k][0] - gpu[k][0]).abs().max()) for k in cpu)
    mdiff = max(float((cpu[k][i] - gpu[k][i]).abs().max() / cpu[k][i].abs().max().clamp_min(1e-30))
                for k in cpu for i in (1, 2))
    moved = max(float((cpu[k][0] - before[k]).abs().max()) for k in cpu)
    msg = (f"policy_mlp_cfg1 resumed, 64x1x16 config-1 CPU trajectory, one update (16 Adam "
           f"steps from step {start}, float32): card vs CPU "
           f"parameters within {diff:.3g} (tolerance {PARAM_TOL}), Adam moments within "
           f"{mdiff:.3g} of their largest (tolerance {MOMENT_TOL}); the update moved the "
           f"parameters up to {moved:.3g}")
    if not (diff <= PARAM_TOL and mdiff <= MOMENT_TOL and moved > 10 * PARAM_TOL):
        phase("resume", "FAIL: " + msg)
        return 1
    phase("resume", msg)
    return 0


def random_actions(rng, n):
    """Seeded (n, 2) actions: throttle from a few levels, steer normal."""
    return np.stack([rng.choice([0.0, 0.5, 1.0, -0.5], n),
                     np.clip(rng.normal(0, 0.4, n), -1, 1)], axis=1).astype(np.float32)


def gym_run(config, device, steps, seed=0):
    """``steps`` steps of a GymIntersectionEnv of ``config`` on ``device``
    with seeded random actions, reset whenever an episode ends: (the obs,
    reward and status of every step, each step's wall ms)."""
    from marl_traffic_intersection_tpu_torch import STATUS_NAMES
    from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv

    env = GymIntersectionEnv({**config, "device": device} if device != "native"
                             else {**config, "device": "cpu", "backend": "native"})
    obs, _ = env.reset(seed=seed)
    rng = np.random.RandomState(seed + 1)
    hist, wall = [obs], []
    for _ in range(steps):
        a = random_actions(rng, env.num_agents)
        t0 = time.perf_counter()
        obs, rew, term, trunc, info = env.step(a[0] if env.traffic_flow else a)
        wall.append(1e3 * (time.perf_counter() - t0))
        hist += [obs, np.asarray(rew, np.float32), np.asarray(info["done"]),
                 np.asarray([STATUS_NAMES.index(x) for x in info["status"]])]
        if term or trunc:
            obs, _ = env.reset()
            hist.append(obs)
    return hist, wall


def k1_times(args, kernels, tag):
    """K1 on ``args`` (the arguments of one of its launches): device, plain
    and bound ms stored in the kernels line under ``*_{tag}``, as a phrase."""
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.ops import lidar_cuda

    _, samples = lidar_scan_ref(*args, return_samples=True)
    (B, N), M = args[0].shape, args[3].shape[1]
    bound, by = k1_bound(B, N, M, samples)
    k = kernels["lidar_scan"]
    k.update({f"ms_{tag}": device_ms(lambda: lidar_cuda.lidar_scan(*args), 50, "lidar_kernel"),
              f"plain_ms_{tag}": cuda_ms(lambda: lidar_scan_ref(*args), 20),
              f"bound_ms_{tag}": bound, f"bound_by_{tag}": by})
    return (f"K1 at {B}x{N} M={M}: device {k[f'ms_{tag}']:.5f} ms, plain "
            f"{k[f'plain_ms_{tag}']:.3f} ms, bound {bound:.7f} ms ({by})")


def gym_phase(dev, card, kernels) -> int:
    """Phase 11 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import evaluate
    from marl_traffic_intersection_tpu_torch.ops import native

    config1 = {"ego_routes": [("IN_6", "OUT_2")]}
    runs = {}
    native.reset_launches()
    with k1_counted() as rec:
        runs["card"] = gym_run(config1, str(dev), 200)
    launches = dict(native.LAUNCHES)
    held, bad = held_to_plain(rec, kernels)
    runs["cpu"] = gym_run(config1, "cpu", 200)
    runs["native"] = gym_run(config1, "native", 2000)
    card_h, cpu_h = runs["card"][0], runs["cpu"][0]
    differ = [i for i, (a, b) in enumerate(zip(card_h, cpu_h))
              if a.shape != b.shape or not np.array_equal(a.view(np.uint8), b.view(np.uint8))]
    missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
    if (len(card_h) != len(cpu_h) or differ or dict(rec.by_m) != {1: 200}
            or launches.get("lidar_scan", 0) != 200 or missing or bad):
        phase("gym", f"FAIL: config-1 gym, 200 steps: card vs CPU differ in {len(differ)} of "
                     f"{len(cpu_h)} arrays; K1 launches by M {dict(rec.by_m)}; kernels not "
                     f"launched {missing}; {bad}")
        return 1
    for k in kernels:
        kernels[k]["launches_gym"] = launches.get(k, 0)
    med = {k: float(np.median(runs[k][1])) for k in runs}
    phase("gym", f"GymIntersectionEnv config 1, 200 steps with seeded random actions: the "
                 f"card's obs, rewards, done and status bit-equal to the CPU's ({len(cpu_h)} "
                 f"arrays); K1 once per step (1x1 M=1) and every kernel launched ({launches}); "
                 f"the kernels on the last step's operands bit-equal to their plain versions: "
                 f"{held}; {k1_times(rec.args, kernels, 'gym')}; median wall ms per step: "
                 f"card {med['card']:.4f}, CPU {med['cpu']:.4f}, native engine "
                 f"{med['native']:.5f} (2000 steps); card {card}")

    for argv in (["--policy", "scripted"],
                 ["--policy", "checkpoint", "--checkpoint", "policy_mlp_cfg1"]):
        got = json_lines(evaluate.main, ["--config", "1", "--episodes", "3", *argv], "gym")[-1]
        if not (got["successes"] == 3 and got["agents_succeeded_frac"] == 1.0
                and got["crashes_vehicle"] == got["crashes_object"] == 0
                and got["device"] != "cpu"):
            phase("gym", f"FAIL: evaluate --episodes 3 {' '.join(argv)}: {got}")
            return 1

    config2 = {"traffic_flow": True, "traffic_density": 0.5, "ego_routes": [("IN_6", "OUT_2")]}
    with k1_counted() as rec:
        hist, wall = gym_run(config2, str(dev), 200)
    held, bad = held_seen(rec, kernels)
    finite = all(np.isfinite(h).all() for h in hist)
    if not finite or dict(rec.by_m) != {33: 200} or bad:
        phase("gym", f"FAIL: config-2 gym: finite {finite}, K1 launches by M "
                     f"{dict(rec.by_m)}; {bad}")
        return 1
    phase("gym", f"GymIntersectionEnv config 2 (traffic, density 0.5), 200 steps: finite, K1 "
                 f"once per step at 1x1 M=33; the kernels on the last step's operands bit-equal "
                 f"to their plain versions ({held}); "
                 f"{k1_times(rec.args, kernels, 'gym_traffic')}; median wall ms per step "
                 f"{float(np.median(wall)):.4f}; card {card}")
    return 0


PLAN_ROUTE = ("IN_6", "OUT_2")          # config 1's left turn
MPC_K, MPC_H, CEM_K, CEM_ITERS, PLANS = 256, 20, 64, 4, 5
# tests/test_torch_planning.py: CEM's elites averaged in another order
CEM_TOL = 1e-5


def planning_phase(dev, card, kernels) -> int:
    """Phase 12 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv
    from marl_traffic_intersection_tpu_torch.algos import (cem_plan, cem_policy, mpc_policy,
                                                           random_shooting_plan)
    from marl_traffic_intersection_tpu_torch.ops import native

    envs = {d: IntersectionEnv(EnvConfig(num_agents=1, max_steps=4000), device=d)
            for d in ("cpu", dev)}
    rid = envs["cpu"].table.route_ids([PLAN_ROUTE])
    snaps = {d: e.reset_state(rid) for d, e in envs.items()}
    env, snap = envs[dev], snaps[dev]

    # closed loop on the card: each planned step timed, K1 counted per plan
    mpc = mpc_policy(env, MPC_K, MPC_H, seed=0)
    cem = cem_policy(env, seed=0, num_candidates=CEM_K, num_iters=CEM_ITERS, horizon=MPC_H)
    for name, plan, per_plan in (("mpc", lambda st, w: (mpc(st)[0], w), MPC_H),
                                 ("cem", lambda st, w: cem(st, w)[::2], CEM_ITERS * MPC_H)):
        st, warm = snap, torch.zeros((MPC_H, 1, 2), device=dev)
        plan(st, warm)                                     # warm-up
        torch.cuda.synchronize()
        ms, counts = [], []
        for _ in range(PLANS):
            native.reset_launches()
            with k1_counted() as rec:
                t0 = time.perf_counter()
                act, warm = plan(st, warm)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            counts.append(dict(native.LAUNCHES))
            st, _ = env.step(st, act.reshape(1, 1, 2))
        # observations are not built while planning, so atan2f does not run
        held, bad = held_to_plain(rec, {k: v for k, v in kernels.items() if counts[-1].get(k)})
        K = MPC_K if name == "mpc" else CEM_K
        k1 = [c.get("lidar_scan", 0) for c in counts]
        if bad or dict(rec.by_m) != {1: per_plan} or k1 != [per_plan] * PLANS \
                or not bool(torch.isfinite(act).all()):
            phase("planning", f"FAIL {name}: K1 launches per plan {k1}, by M {dict(rec.by_m)} "
                              f"(want {per_plan} at M=1); {bad}; action {act}")
            return 1
        for k in kernels:
            kernels[k][f"launches_plan_{name}"] = counts[-1].get(k, 0)
        phase("planning", f"{name} on config 1 ({K} candidates, horizon {MPC_H}"
                          f"{f', {CEM_ITERS} iterations' if name == 'cem' else ''}): ms per "
                          f"planned step {[round(x, 3) for x in ms]}; launches per plan "
                          f"{counts[-1]}; the kernels on the last plan's operands bit-equal to "
                          f"their plain versions: {held}; {k1_times(rec.args, kernels, f'plan_{name}')}"
                          f"; card {card}")

    # card against CPU on injected draws
    rng = np.random.RandomState(5)
    noise = torch.from_numpy(rng.uniform(-1, 1, (MPC_H, MPC_K, 1, 2)).astype(np.float32))
    a0 = torch.from_numpy(rng.uniform(-1, 1, (MPC_K, 1, 2)).astype(np.float32))
    normals = torch.from_numpy(rng.normal(size=(CEM_ITERS, MPC_H, CEM_K, 1, 2)).astype(np.float32))
    shot, cems = {}, {}
    for d in ("cpu", dev):
        shot[d] = [t.cpu() for t in random_shooting_plan(
            envs[d], snaps[d], num_candidates=MPC_K, horizon=MPC_H, noise=noise, a0=a0)]
        cems[d] = [t.cpu() for t in cem_plan(envs[d], snaps[d], num_candidates=CEM_K,
                                              num_iters=CEM_ITERS, horizon=MPC_H,
                                              normals=normals)]
    shot_equal = all(bits_equal(a, b) for a, b in zip(shot["cpu"], shot[dev]))
    scale = float(cems["cpu"][2].abs().max())
    cem_diff = max(float((cems["cpu"][i] - cems[dev][i]).abs().max()) for i in (0, 2))
    if not shot_equal or cem_diff > CEM_TOL * scale:
        phase("planning", f"FAIL: card vs CPU on injected draws: random shooting "
                          f"{shot[dev]} vs {shot['cpu']}; CEM mean and action within "
                          f"{cem_diff:.3g} (tolerance {CEM_TOL} x {scale:.3g})")
        return 1
    phase("planning", f"card vs CPU on injected draws: random shooting's best action "
                      f"{shot['cpu'][0].tolist()} and return {float(shot['cpu'][1])} bit-equal; "
                      f"CEM's mean and first action within {cem_diff:.3g} (tolerance {CEM_TOL} "
                      f"of {scale:.3g}); card {card}")
    return 0


def train_child(argv) -> int:
    """``train.main(argv)`` (under torchrun for --distributed) with K1's and
    the libm kernels' launches counted and each kernel held against its plain
    version on its last operands at each shape, as the train phase does, and
    the torch.distributed collectives of each update counted (from one
    update's start to the next's; the last to the run's end, its checkpoint
    included); rank 0 prints one JSON line ``{"child": ...}``. 1 if a kernel
    disagrees or never launched."""
    from marl_traffic_intersection_tpu_torch import train
    from marl_traffic_intersection_tpu_torch.ops import libm, native
    from marl_traffic_intersection_tpu_torch.parallel.ppo import TrainStep
    from marl_traffic_intersection_tpu_torch.utils.profiling import collective_census

    native.reset_launches()
    starts = []

    def counted(step):          # an update starts where the step is called
        def call(self, *args, **kw):
            starts.append(len(calls))
            return step(self, *args, **kw)
        return call

    # one process on the card runs the graphed step, torchrun's world the eager
    # one: both are TrainStep.train
    with k1_counted() as rec, collective_census() as calls, \
            mock.patch.object(TrainStep, "train", counted(TrainStep.train)):
        train.main(argv)
    launches = dict(native.LAUNCHES)        # before the comparisons launch again
    per_update = [b - a for a, b in zip(starts, starts[1:] + [len(calls)])]
    names = ["lidar_scan"] + [n for n in LIBM if libm.KERNEL_OF.get(n, n) == n]
    held, bad = held_to_plain(rec, dict.fromkeys(names))
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps({"child": {"launches": launches, "held": held, "bad": bad,
                                    "collectives": calls[:8], "collectives_total": len(calls),
                                    "collectives_per_update": per_update}}), flush=True)
    return 1 if bad else 0


def spread(xs) -> dict:
    """The median and range of a few timings."""
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs), "all": list(xs)}


DIST_PARAM_TOL, DIST_MOMENT_TOL = 1e-5, 1e-4
DIST_UPDATES = 6


def distributed_phase(dev, card, kernels) -> int:
    """Phase 13 (see the module docstring); 1 on failure."""
    import torch.distributed as dist

    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.dryrun import _free_port, dryrun_multichip
    from marl_traffic_intersection_tpu_torch.models import make_model
    from marl_traffic_intersection_tpu_torch.parallel.mesh import make_mesh
    from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner, Transition
    from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint

    # (a) train --distributed at full width over NCCL (world 1), in turns with
    # the same command in one process: 6 updates, the first the warm-up,
    # updates 1-4 timed, the last profiled
    B, N, T = TRAIN_B, TRAIN_N, TRAIN_T
    U = DIST_UPDATES
    root = os.path.dirname(os.path.abspath(__file__))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    timing = {"distributed": [], "one process": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, distributed in enumerate((True, False)):
            ck = os.path.join(tmp, f"run{i}")
            argv = ["--num-envs", str(B), "--agents", str(N), "--rollout-len", str(T),
                    "--updates", str(U), "--log-every", "1", "--checkpoint", ck,
                    "--profile", os.path.join(tmp, f"trace{i}.json.gz")]
            cmd = (torchrun if distributed else [sys.executable]) + [
                os.path.abspath(__file__), "--train-child", *argv,
                *(["--distributed"] if distributed else [])]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root)
            secs = time.perf_counter() - t0
            lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
            logs = [ln for ln in lines if "update" in ln]
            child = next((ln["child"] for ln in lines if "child" in ln), None)
            prof = next((ln["profile"] for ln in lines if "profile" in ln), {})
            name = "distributed" if distributed else "one process"
            if r.returncode != 0 or child is None:
                phase("distributed", f"FAIL: {name} run exited {r.returncode}:\n"
                                     f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
                return 1
            launches, saved = child["launches"], restore_checkpoint(ck)
            missing = [k for k in STEP_KERNELS if launches.get(k, 0) == 0]
            steps = 16 * U
            if (len(logs) != U or not losses_finite(logs) or saved["update_count"] != steps
                    or launches.get("lidar_scan", 0) != U * T or missing or child["bad"]):
                phase("distributed", f"FAIL: {name}: {len(logs)} log lines, losses finite "
                                     f"{losses_finite(logs)}, update_count "
                                     f"{saved['update_count']} (want {steps}), launches "
                                     f"{launches}, never launched {missing}, {child['bad']}")
                return 1
            per_update = child["collectives_per_update"]
            if len(per_update) != U or any(per_update):
                phase("distributed", f"FAIL: {name}: collectives per update {per_update} "
                                     f"(want {U} updates of 0: no collective over an axis of "
                                     f"one rank), the first {child['collectives']}")
                return 1
            if i == 0:
                for k in kernels:
                    kernels[k]["launches_distributed"] = launches.get(k, 0)
                mesh_line = next((ln for ln in r.stdout.splitlines() if ln.startswith("ranks=")),
                                 "")
                phase("distributed", f"train --distributed under torchrun, {B}x{N}, rollout "
                                     f"{T}, {U} updates ({mesh_line}): {steps} optimizer steps, "
                                     f"finite losses, launches in the child {launches}; the "
                                     f"kernels on their last operands bit-equal to their plain "
                                     f"versions: {child['held']}; collectives per update "
                                     f"{per_update}, {child['collectives_total']} in the whole "
                                     f"run (census of torch.distributed's calls)")
            top = [(k["name"][:50], round(k["ms_per_step"], 3), k["launches_per_step"])
                   for k in prof.get("top_kernels", [])]
            timed = logs[1:U - 1]
            timing[name].append(dict(
                wall_s=round(secs, 3), env_steps_per_s=[ln["env_steps_per_s"] for ln in timed],
                rollout_s=spread([ln["rollout_s"] for ln in timed]),
                update_s=spread([ln["update_s"] for ln in timed]),
                collectives_per_update=per_update,
                profiled_update=dict(
                    window_ms=round(prof.get("window_ms_per_step", 0), 1),
                    device_busy_ms=round(prof.get("device_busy_ms_per_step", 0), 1),
                    busy_share=round(prof.get("device_busy_share", 0), 4),
                    launches=prof.get("kernel_launches_per_step"), top_kernels=top)))
    launched = {k: v[0]["profiled_update"]["launches"] for k, v in timing.items()}
    phase("distributed", f"in turns (distributed, then one process), {U} updates each: the "
                         f"first the warm-up, updates 1-{U - 2} timed (median and range of "
                         f"rollout_s and update_s), the last profiled: {json.dumps(timing)}; "
                         f"launches per profiled update {launched} (distributed minus one "
                         f"process: {launched['distributed'] - launched['one process']}); "
                         f"card {card}")

    # (b) one float32 update of a fixed CPU trajectory through the distributed
    # learner at world 1 (NCCL) and the plain learner, both on the card
    cfg16 = PPOConfig(rollout_len=16)
    f32 = dict(compute_dtype=torch.float32)
    cpu_venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4), device="cpu"), num_envs=64,
                         seed=3)
    g = torch.Generator().manual_seed(9)
    perms = [torch.randperm(16, generator=g) for _ in range(cfg16.update_epochs)]
    lrn = PPOLearner(cpu_venv, make_model("mlp", seed=5, **f32), cfg16, seed=4)
    s0, o0 = cpu_venv.reset()
    _, _, traj, lv = lrn.rollout(lrn.init(), s0, o0)
    advs, rets = lrn._gae(traj, lv)
    updated = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1)
        for which in ("plain", "distributed"):
            queue = [p.to(dev) for p in perms]
            ven = VectorEnv(IntersectionEnv(EnvConfig(num_agents=4), device=dev), num_envs=64)
            lrn = PPOLearner(ven, make_model("mlp", seed=5, **f32), cfg16, seed=4,
                             perm_fn=lambda n, q=queue: q.pop(0))
            t_s = lrn.init()
            if which == "distributed":
                _, shard_ts, _ = lrn.distributed(mesh, "mlp")
                t_s = shard_ts(t_s)
            t_s, _ = lrn.update(t_s, Transition(*(t.to(dev) for t in traj)), advs.to(dev),
                                rets.to(dev))
            st = t_s.optimizer.state
            updated[which] = {k: [v.detach().cpu()] + [st[v][m].cpu() for m in
                                                       ("exp_avg", "exp_avg_sq")]
                              for k, v in t_s.model.named_parameters()}
    finally:
        dist.destroy_process_group()
    a, b = updated["plain"], updated["distributed"]
    diff = max(float((a[k][0] - b[k][0]).abs().max()) for k in a)
    mdiff = max(float((a[k][i] - b[k][i]).abs().max() / a[k][i].abs().max())
                for k in a for i in (1, 2))
    msg = (f"64x4x16 CPU trajectory, one float32 update (16 Adam steps) through the "
           f"distributed learner at world 1 (NCCL) and the plain learner on the card: "
           f"parameters within {diff:.3g} (tolerance {DIST_PARAM_TOL}), Adam moments within "
           f"{mdiff:.3g} of their largest (tolerance {DIST_MOMENT_TOL})")
    if not (diff <= DIST_PARAM_TOL and mdiff <= DIST_MOMENT_TOL):
        phase("distributed", "FAIL: " + msg)
        return 1
    phase("distributed", msg)

    # (c) the dry run of every family in one NCCL process
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = dryrun_multichip(1, "cuda", timeout=300)
    want = [f"dryrun ok: {kind} dp=1 tp=1" for kind in (
        "mlp", "attention", "conv", "gru", "central", "sac", "mlp+traffic", "gru+traffic",
        "sac+traffic")]
    if lines != want:
        phase("distributed", f"FAIL: dryrun_multichip(1, 'cuda') gave {lines}")
        return 1
    phase("distributed", f"dryrun_multichip(1, 'cuda'): {len(lines)} families ok in "
                         f"{time.perf_counter() - t0:.1f} s")

    # (d) two ranks on the one card: NCCL refuses two ranks on one device,
    # gloo stages the card's tensors through the host
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = dryrun_multichip(2, "cuda", backend="gloo", timeout=300)
    want = [f"dryrun ok: {kind} dp={2 // tp} tp={tp}" for kind in (
        "mlp", "attention", "conv", "gru", "central", "sac", "mlp+traffic", "gru+traffic",
        "sac+traffic") for tp in (1, 2)]
    if lines != want:
        phase("distributed", f"FAIL: dryrun_multichip(2, 'cuda', backend='gloo') gave {lines}")
        return 1
    phase("distributed", f"dryrun_multichip(2, 'cuda', backend='gloo'), two ranks on cuda:0: "
                         f"{len(lines)} family steps ok (dp 2 and tp 2) in "
                         f"{time.perf_counter() - t0:.1f} s")

    # (e) the bench's line, at 2 repeats: vs_baseline over the pinned rate
    # of 4 agents (BASELINE.json's measured_reference)
    from marl_traffic_intersection_tpu_torch import bench

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"BENCH_REPEATS": "2"}):
        lines = json_lines(lambda _: bench.main(), None, "distributed")
    line, ref = (lines[0] if lines else {}), 3004.4
    # value is rounded to 0.1 and vs_baseline taken from the unrounded median
    if (line.get("baseline_ref_steps_per_s") != ref or not line.get("value", 0) > 0
            or abs(line.get("vs_baseline", 0) - line["value"] / ref) > 0.0051
            or not line.get("metric", "").endswith("lidar on), exact_trig")):
        phase("distributed", f"FAIL: bench line {line}")
        return 1
    phase("distributed", f"bench (BENCH_REPEATS=2): {line['value']} env-steps/s, vs_baseline "
                         f"{line['vs_baseline']} over the pinned {ref}, in "
                         f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
