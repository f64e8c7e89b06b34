"""Smoke test of the PyTorch port on one NVIDIA card (H100).

  python3 chip_smoke.py
  python3 chip_smoke.py --k1-baseline DIR [DIR ...]   # also times DIR/lidar.cu

Phases, one line each; any failure exits nonzero:
  1. device   the card's name, count, and nvidia-smi's name and power limit;
              no CUDA device -> exit 1
  2. build    every CUDA source of the port (and the CPU libm shim) built with
              nvcc/g++ in parallel, with ptxas's register and spill lines
  3. libm     the glibc-faithful sinf/cosf/tanf/atan2f/hypotf kernels on 2^22
              seeded inputs, bit-equal to the same header built for this
              machine's CPU (decides); against this machine's glibc (shown)
  4. K1       the lidar kernel against its plain PyTorch version on the card,
              bit-equal, at the main path's 4096x4 shapes, on 36-slot fuzz
              shapes and on NaN/inf/-0.0/screen-edge poses; device times at
              4096x4 M=4 and 512x8 M=36 (and, with --k1-baseline, those of
              other builds of lidar.cu, in turns), plain and bound times
  5. main     VectorEnv(4096 envs x 4 agents) with a seeded 256-256 bf16
              ActorCriticMLP in the loop for 200 steps, through the kernels
              (launch counters); then 64 envs x 100 steps on the card and on
              the CPU with the same resets and actions, bit-equal
  6. train    the train entry point (PPO) at 4096 x 4, rollout 64, 4 epochs x
              4 minibatches, bf16 MLP: 3 updates with a checkpoint, then one
              more by auto-resume; finite losses, 48 optimizer steps, K1
              launched 64 x 3 times and every kernel at least once (launch
              counters); env-steps/s, the rollout/update split and peak
              memory; then the same entry point at the same size for 4
              updates each of the MLP with --norm-reward, conv, central and
              attention: finite losses, K1 launched 64 x 4 times, the split,
              peak memory; each run's last update profiled (device busy
              share, launches, top kernels; Chrome traces in chiprun_out/);
              last, one update of a fixed 64 x 4 x 16 CPU trajectory on the
              card and on the CPU in float32, parameters within 1e-5 and
              Adam's moments within 1e-4 of their largest, the update moving
              the parameters more than ten times that
  7. traffic  BASELINE config 4 (8 agents, density 1.0, 32 NPC slots, exact
              NPC mode) at 4096 envs for 200 steps with the bf16 MLP in the
              loop, spawns drawn on the card: finite obs, NPCs spawned, K1
              launched once per step at M = 40 and every kernel at least once;
              env-steps/s, launches and device reads per step, the NPC loops'
              rounds, alive slots per env (batch max and mean), peak memory,
              a profile (busy share, top kernels); then 100 steps in the fast
              NPC mode. K1 on that run's obstacle sets bit-equal to the plain
              version and timed ("4096x8 M=40 traffic"). 64 envs x 8 agents x
              200 steps with a spawn try every step and resets at step 175:
              the card run bit-equal to the CPU run, and on the card the
              exact mode's slot and wave schedules, whose cleanup replays and
              collision cascade must both have run, bit-equal to the serial
              transcription. Last, the train
              entry point with --traffic --density 1.0 at 4096 x 4: 3 updates
              and one more by auto-resume, finite losses
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
              at M = 40, completions, crashes and env-steps/s; serve with
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
              steps of config 2 (traffic), finite, K1 once per step at M=33 and
              bit-equal to its plain version there
Then one JSON line of every kernel's numbers, the card line, and last the
result line {"ok": true, "device": {...}}.

Kernel times ("ms") are device times per launch: torch.profiler's self
device time of the kernel over many launches. "event_ms" is the CUDA-event
time of back-to-back calls of the wrapper, which includes the host's
dispatch whenever a launch is shorter than the wrapper's Python call.
"launch_floor_ms" (libm rows) is the device time of the smallest launch, a
torch.add of two 1-element tensors. "launches" counts the main phase's
launches, "launches_train" those of the train phase's 3 updates,
"launches_traffic" those of the traffic phase's 200 exact-mode steps,
"launches_eval_config4" those of 200 config-4 evaluate steps with the GRU
policy, "launches_gru_train" those of the 3 GRU updates at 4096 x 4 (and
their reset's observation), "launches_sac_train" those of train_sac at
256 x 2: 16 demo steps, then 40 calls of 8 env steps and updates,
"launches_resume" those of the 2 resumed attention updates at 1024 x 4, and
"launches_gym" those of the 200 config-1 gym steps on the card.
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


def device_ms(fn, reps, match=None, tries=5):
    """Mean device milliseconds per launch of the kernels whose name contains
    ``match`` (all kernels if None), from the self device time torch.profiler
    records over ``reps`` calls of ``fn``, each making one launch. The
    profiler now and then loses a window's kernel records; such a window is
    profiled again, and after ``tries`` the mean is over the launches kept."""
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
        if got[0] == reps:
            break
        phase("timing", f"the profiler recorded {got[0]} launches of {match!r} in {reps} calls")
    launches, us = best
    if not launches or us <= 0:
        raise RuntimeError(f"the profiler recorded no device time for {match!r}")
    return us / 1e3 / launches


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
    """The ptxas numbers of the one entry whose mangled name contains ``key``."""
    hits = [v for k, v in info.items() if key in k and "registers" in v]
    if len(hits) != 1:
        raise RuntimeError(f"ptxas output: {len(hits)} entries match {key!r}")
    return {k: hits[0].get(k) for k in ("registers", "stack_bytes", "spill_stores",
                                        "spill_loads")}


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-baseline", metavar="DIR", nargs="+", default=[],
                    help="directories each holding another lidar.cu (and the headers it "
                         "includes), e.g. csrc/ of an earlier commit; each kernel is checked "
                         "and timed in turns with this one")
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
    baselines = {}            # other lidar.cu files, built beside ours with the same flags
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    for j, d in enumerate(opts.k1_baseline):
        native.BUILD.mkdir(parents=True, exist_ok=True)
        so = native.BUILD / f"lidar-baseline-{j}.so"
        baselines[d] = (so, subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, os.path.join(d, "lidar.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sources = ["libm.cu", "lidar.cu", "libm_host.cpp"]
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
    specs = {   # name: (args, bytes moved per element, f64 ops per element, library call,
                #        replaces, the kernel's functor in libm.cu)
        "sinf": ((x,), 8, 14, torch.sin, "marl_traffic_intersection_tpu/ops/exact_trig.py:145",
                 "SinF"),
        "cosf": ((x,), 8, 14, torch.cos, "marl_traffic_intersection_tpu/ops/exact_trig.py:162",
                 "CosF"),
        "tanf": ((x,), 8, 40, torch.tan, "marl_traffic_intersection_tpu/ops/exact_trig.py:299",
                 "TanF"),
        "atan2f": ((y, x), 12, 40, torch.atan2,
                   "marl_traffic_intersection_tpu/ops/exact_libm.py:279", "Atan2F"),
        "hypotf": ((x * 100, y * 100), 12, 6, torch.hypot,
                   "marl_traffic_intersection_tpu/ops/exact_libm.py:188", "HypotF"),
    }
    glibc = os.confstr("CS_GNU_LIBC_VERSION")
    one = torch.ones(1, device=dev)
    floor_ms = device_ms(lambda: torch.add(one, one), 200)
    phase("libm", f"launch floor: torch.add of two 1-element tensors, device {floor_ms:.7f} ms; "
                  f"card {card}")
    bshape = (4096, 4)    # the env's (B, N) at the main path
    for name, (args, bpe, ope, lib_fn, replaces, functor) in specs.items():
        fn = getattr(libm, name)
        dargs = [torch.from_numpy(a).to(dev) for a in args]
        got = fn(*dargs).cpu().numpy()
        want = libm.transcribed_np(name, *args)
        n_diff = int((got.view(np.int32) != want.view(np.int32)).sum())
        n_glibc = int((got.view(np.int32) != libm.glibc_np(name, *args).view(np.int32)).sum())
        if n_diff:
            phase("libm", f"FAIL {name}: {n_diff} of {got.size} differ from the CPU build")
            return 1
        small = [torch.from_numpy(a[:bshape[0] * bshape[1]].reshape(bshape)).to(dev)
                 for a in args]
        small_cpu = [t.cpu() for t in small]
        n = small[0].numel()
        kernels[name] = dict(
            name=name, route="cuda", source=SRC + "libm.cu", replaces=replaces,
            max_abs_err=float(np.abs(got.astype(np.float64) - want).max()),
            ms=device_ms(lambda: fn(*small), 200, functor),
            event_ms=cuda_ms(lambda: fn(*small), 200),
            plain_ms=host_ms(lambda: fn(*small_cpu), 20),
            bound_ms=1e3 * max(n * bpe / HBM_BYTES_PER_S, n * ope / F64_OPS_PER_S),
            bound_by="bytes" if n * bpe / HBM_BYTES_PER_S >= n * ope / F64_OPS_PER_S
            else "operations",
            library_ms=device_ms(lambda: lib_fn(*small), 200),
            launch_floor_ms=floor_ms,
            **kernel_regs(ptxas, functor))
        k = kernels[name]
        phase("libm", f"{name}: bit-equal to the CPU build on {got.size} inputs; "
                      f"{n_glibc} differ from this machine's {glibc} (shown only); at {bshape}: "
                      f"device {k['ms']:.5f} ms (events, with the host: {k['event_ms']:.4f}); "
                      f"torch.{lib_fn.__name__}, not glibc-exact, device {k['library_ms']:.5f} ms")

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
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        phase("main", f"FAIL: kernels not launched on the main path: {missing}")
        return 1
    for k in kernels:
        kernels[k]["launches"] = launches[k]
    phase("main", f"4096x4, 200 steps, bf16 MLP in the loop: "
                  f"{4096 * 200 / secs:.1f} env-steps/s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}; "
                  f"card {card}")
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

    for name, fn in (("train", train_phase), ("traffic", traffic_phase),
                     ("policies", policies_phase), ("learners", learners_phase),
                     ("resume", resume_phase), ("gym", gym_phase)):
        t0 = time.perf_counter()
        if fn(dev, card, kernels):
            return 1
        phase(name, f"phase done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


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
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        if missing:
            phase("train", f"FAIL: kernels not launched in training: {missing}")
            return 1
        for k in kernels:
            kernels[k]["launches_train"] = launches[k]
        phase("train", f"{B}x{N}, rollout {T}, 3 updates in {secs:.3f} s (builds warm): "
                       f"env-steps/s by update {[ln['env_steps_per_s'] for ln in logs]}, "
                       f"launches {launches}")
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
            _, _, traj_cpu, lv = lrn._rollout(t_s.model, s0, o0)
            advs_cpu, rets_cpu = lrn._gae(traj_cpu, lv)
        tr = Transition(*(t.to(d) for t in traj_cpu))
        t_s, _ = lrn._update(t_s, tr, advs_cpu.to(d), rets_cpu.to(d))
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
    env's ``lidar_scan`` wrapped; ``.args`` keeps the last launch's arguments
    and ``.libm`` each libm kernel's last operands on the card, for
    ``held_to_plain``."""
    from marl_traffic_intersection_tpu_torch.core import env as env_module
    from marl_traffic_intersection_tpu_torch.ops import libm

    scan, apply = env_module.lidar_scan, libm._apply
    rec = types.SimpleNamespace(by_m=collections.Counter(), args=None, libm={})

    def counted(*args, **kw):
        rec.by_m[args[3].shape[1]] += 1
        rec.args = args
        return scan(*args, **kw)

    def recorded(name, *xs):
        if xs[0].is_cuda:
            rec.libm[name] = xs
        return apply(name, *xs)

    env_module.lidar_scan, libm._apply = counted, recorded
    try:
        yield rec
    finally:
        env_module.lidar_scan, libm._apply = scan, apply


def held_to_plain(rec, kernels) -> tuple:
    """K1 on the last arguments ``k1_counted`` kept, and every libm kernel of
    ``kernels`` on its last operands, against their plain versions
    (``lidar_scan_ref``; the same wrapper on the CPU, the host build of
    libm.cu's functions), bit for bit: (the shapes held, the failures)."""
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.ops import libm, lidar_cuda

    held, bad = [], []
    if rec.args is None:
        bad.append("lidar_scan never launched")
    else:
        got, ref = lidar_cuda.lidar_scan(*rec.args), lidar_scan_ref(*rec.args)
        B, N = rec.args[0].shape
        held.append(f"lidar_scan {B}x{N} M={rec.args[3].shape[1]}")
        if not bits_equal(got, ref):
            bad.append(f"lidar_scan differs from lidar_scan_ref on "
                       f"{int((got.cpu().view(torch.int32) != ref.cpu().view(torch.int32)).sum())}"
                       f" rays at {held[-1]}")
    for name in (k for k in kernels if k != "lidar_scan"):
        xs = rec.libm.get(name)
        if xs is None:
            bad.append(f"{name} never launched")
            continue
        fn = getattr(libm, name)
        got, want = fn(*xs), fn(*(x.cpu() for x in xs))
        held.append(f"{name} {tuple(got.shape)}")
        if not bits_equal(got, want):
            bad.append(f"{name} differs from its CPU build on "
                       f"{int((got.cpu().view(torch.int32) != want.view(torch.int32)).sum())} of "
                       f"{got.numel()} operands")
    return held, bad


def traffic_runs(dev, modes, B=64):
    """The histories of ``B`` envs of config 4 on ``dev`` over TRY_STEPS
    steps for each (npc_mode, npc_cleanup) in ``modes``, with the same
    resets, actions and injected spawns; the first run's NPC-steps (alive
    NPCs summed over steps); and each run's ``npc_stats`` (the exact mode's
    loop rounds and device reads) with its seconds."""
    from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
    from marl_traffic_intersection_tpu_torch.core.routes import default_ego_routes

    runs, alive, stats = {}, 0, {}
    for mode, cleanup in modes:
        t0 = time.perf_counter()
        env = IntersectionEnv(EnvConfig(npc_mode=mode, npc_cleanup=cleanup,
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


def npc_breakdown(env, state) -> dict:
    """Device and wall ms per call of the exact NPC update and of its dense
    ghost-scan plan alone, on ``state``'s NPC pool (torch.profiler, 5 calls)."""
    from marl_traffic_intersection_tpu_torch.core import npc as npc_module
    from marl_traffic_intersection_tpu_torch.core.constants import DT_DEFAULT, PATH_LEN
    from marl_traffic_intersection_tpu_torch.core.physics import update_path_index
    from marl_traffic_intersection_tpu_torch.ops import libm
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    pool, ego, dev = state.npc, state.ego, env.device
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
        "dense plan (B, 32, 32, 160)": lambda: npc_module._plan(*poses, others, pi0, paths,
                                                                poses),
    }
    out = {}
    for name, fn in parts.items():
        prof = profile_steps(fn, 5)
        out[name] = {k: round(prof[k], 3) for k in ("device_busy_ms_per_step",
                                                    "window_ms_per_step",
                                                    "kernel_launches_per_step")}
    return out


def traffic_phase(dev, card, kernels) -> int:
    """Phase 7 (see the module docstring); 1 on failure."""
    from marl_traffic_intersection_tpu_torch import (ActorCriticMLP, EnvConfig,
                                                     IntersectionEnv, VectorEnv)
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.ops import lidar_cuda, native
    from marl_traffic_intersection_tpu_torch.utils.profiling import profile_steps

    B, N, STEPS = TRAFFIC_B, TRAFFIC_N, TRAFFIC_STEPS
    torch.manual_seed(0)
    model = ActorCriticMLP().to(dev)
    with torch.no_grad():
        # a cruise bias on the throttle mean (tanh(1) = 0.76): the seeded
        # policy alone idles at the spawn points, and an ego there blocks
        # every NPC spawn near it
        model.pi_mean.bias[0] += 1.0
    for mode, steps in (("exact", STEPS), ("fast", 100)):
        env = IntersectionEnv(EnvConfig(npc_mode=mode, **TRAFFIC_CFG), device=dev)
        venv = VectorEnv(env, num_envs=B, seed=2)
        state, obs = venv.reset()
        for _ in range(5):                                  # warm-up
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
        finite = bool(torch.isfinite(obs).all())
        if obs.shape != (B, N, 127) or not finite or int(spawned) == 0:
            phase("traffic", f"FAIL {mode}: obs {tuple(obs.shape)} finite={finite}, "
                             f"{int(spawned)} NPCs spawned")
            return 1
        if dict(k1.by_m) != {N + 32: steps} or launches.get("lidar_scan", 0) != steps:
            phase("traffic", f"FAIL {mode}: K1 launches by obstacle count {dict(k1.by_m)} "
                             f"(want {{{N + 32}: {steps}}})")
            return 1
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        if missing:
            phase("traffic", f"FAIL {mode}: kernels not launched: {missing}")
            return 1
        prof = profile_steps(lambda: venv.step(state, model.act(obs)), 5)
        top = [(k["name"][:60], round(k["ms_per_step"], 3), k["launches_per_step"])
               for k in prof.pop("top_kernels")[:8]]
        per_env = alive.float()
        phase("traffic", f"config 4 {mode}, {B}x{N}, {steps} steps, bf16 MLP in the loop: "
                         f"{B * steps / secs:.1f} env-steps/s; {int(spawned)} NPCs spawned; "
                         f"alive slots per env: batch max {int(alive.max())}, mean "
                         f"{float(per_env.mean()):.3f}, batch max by step mean "
                         f"{float(per_env.amax(1).mean()):.2f}; kernel launches {launches} "
                         f"({sum(launches.values()) / steps:.1f} per step); device reads and "
                         f"NPC loop rounds {stats} ({stats.get('host_reads', 0) / steps:.2f} "
                         f"reads per step); peak memory {peak / 2**20:.1f} MiB; profile of 5 "
                         f"steps {json.dumps(prof)}; top kernels (name, ms, launches per step) "
                         f"{top}; card {card}")
        if mode == "exact":
            for k in kernels:
                kernels[k]["launches_traffic"] = launches[k]
            args = list(k1.args)
            phase("traffic", f"where the exact step's device time goes, on its last pool: "
                             f"{json.dumps(npc_breakdown(env, state))}; card {card}")

    # K1 on the exact run's last obstacle set, against its plain version, timed
    got = lidar_cuda.lidar_scan(*args)
    ref, samples = lidar_scan_ref(*args, return_samples=True)
    if not bits_equal(got, ref):
        diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        phase("traffic", f"FAIL: K1 differs from lidar_scan_ref on {diff} traffic rays")
        return 1
    M = args[3].shape[1]
    bound, by = k1_bound(B, N, M, samples)
    warps = samples.reshape(-1, 32).double()
    k = kernels["lidar_scan"]
    k.update(ms_traffic=device_ms(lambda: lidar_cuda.lidar_scan(*args), 50, "lidar_kernel"),
             plain_ms_traffic=cuda_ms(lambda: lidar_scan_ref(*args), 3),
             bound_ms_traffic=bound, bound_by_traffic=by,
             max_abs_err_traffic=float((got - ref).abs().max()),
             lane_efficiency_traffic=float(warps.sum() / (32 * warps.max(1).values).sum()),
             blocks_per_sm_traffic=lidar_cuda.blocks_per_sm(M))
    phase("traffic", f"K1 {B}x{N} M={M} traffic: bit-equal to the plain version "
                     f"({got.numel()} rays, {int(samples.sum())} samples marched, "
                     f"{int(args[6].sum())} obstacles present); device {k['ms_traffic']:.5f} ms, "
                     f"plain {k['plain_ms_traffic']:.3f} ms, bound {bound:.5f} ms ({by}), lane "
                     f"efficiency {k['lane_efficiency_traffic']:.4f}, "
                     f"{k['blocks_per_sm_traffic']} blocks per SM; card {card}")

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
        logs, _ = run_train(argv + ["--updates", "3"])
        resumed, _ = run_train(argv + ["--updates", "4"])
        peak = torch.cuda.max_memory_allocated()
        saved = restore_checkpoint(argv[-1])
        if (len(logs) != 3 or not losses_finite(logs) or [ln["update"] for ln in resumed] != [3]
                or not losses_finite(resumed) or saved["update"] != 4
                or int(saved["env_state"]["npc.next_uid"].sum()) == 0):
            phase("traffic", f"FAIL: train --traffic logged {logs} then {resumed}; saved update "
                             f"{saved['update']}")
            return 1
    phase("traffic", f"train --traffic --density 1.0, {TRAIN_B}x{TRAIN_N}, rollout {TRAIN_T}: "
                     f"env-steps/s by update {[ln['env_steps_per_s'] for ln in logs + resumed]}, "
                     f"rollout s {[ln['rollout_s'] for ln in logs + resumed]}, update s "
                     f"{[ln['update_s'] for ln in logs + resumed]}; peak memory "
                     f"{peak / 2**20:.1f} MiB; card {card}")
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

    # ---- config 4 (8 agents, traffic): K1 at M = 40 once per step
    for name in ("policy_attn_multi", "policy_gru_multi", "policy_central_cfg4",
                 "policy_sac_multi"):
        native.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with k1_counted() as k1:
            got = run_eval(["--config", "4", "--vector", "4096", "--max-steps", "200",
                            "--policy", "checkpoint", "--checkpoint", f"artifacts/{name}",
                            "--model", SHIPPED[name]])
        launches = dict(native.LAUNCHES)
        phase("policies", f"config 4, {name}, 4096 x 8, 200 exact steps: completions "
                          f"{got['successes']}, crashes {got['crashes_vehicle']} vehicle + "
                          f"{got['crashes_object']} object in {got['episodes']} episodes, "
                          f"mean episode reward {got['mean_ep_reward']}, "
                          f"{got['env_steps_per_s']} env-steps/s, K1 launches by M "
                          f"{dict(k1.by_m)}, peak memory "
                          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card}")
        if not np.isfinite(got["mean_ep_reward"]) or dict(k1.by_m) != {40: 200} \
                or launches.get("lidar_scan", 0) != 200:
            phase("policies", f"FAIL: {name} on config 4: {got}, launches {launches}")
            return 1
        if name == "policy_gru_multi":
            missing = [k for k in kernels if launches.get(k, 0) == 0]
            if missing:
                phase("policies", f"FAIL: kernels not launched in evaluate: {missing}")
                return 1
            for k in kernels:
                kernels[k]["launches_eval_config4"] = launches[k]

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
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        phase("learners", f"FAIL: kernels not launched in GRU training: {missing}")
        return 1
    for k in kernels:
        kernels[k]["launches_gru_train"] = launches[k]
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
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        phase("learners", f"FAIL: kernels not launched in SAC training: {missing}")
        return 1
    for k in kernels:
        kernels[k]["launches_sac_train"] = launches[k]
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
            _, _, _, traj_cpu, lv = lrn._rollout(ts.model, s0, o0, lrn.initial_hidden())
            advs, rets = lrn._gae(traj_cpu, lv)
        ts, _ = lrn._update(ts, RecTransition(*(t.to(d) for t in traj_cpu)), advs.to(d),
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
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        if missing:
            phase("resume", f"FAIL: kernels not launched in the fine-tune: {missing}")
            return 1
        for k in kernels:
            kernels[k]["launches_resume"] = launches[k]
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
            _, _, traj_cpu, lv = lrn._rollout(ts.model, s0, o0)
            advs_cpu, rets_cpu = lrn._gae(traj_cpu, lv)
            before = {k: v.detach().clone() for k, v in ts.model.named_parameters()}
        ts, _ = lrn._update(ts, Transition(*(t.to(d) for t in traj_cpu)), advs_cpu.to(d),
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
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if (len(card_h) != len(cpu_h) or differ or dict(rec.by_m) != {1: 200}
            or launches.get("lidar_scan", 0) != 200 or missing or bad):
        phase("gym", f"FAIL: config-1 gym, 200 steps: card vs CPU differ in {len(differ)} of "
                     f"{len(cpu_h)} arrays; K1 launches by M {dict(rec.by_m)}; kernels not "
                     f"launched {missing}; {bad}")
        return 1
    for k in kernels:
        kernels[k]["launches_gym"] = launches[k]
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
    held, bad = held_to_plain(rec, {k: v for k, v in kernels.items() if k == "lidar_scan"})
    finite = all(np.isfinite(h).all() for h in hist)
    if not finite or dict(rec.by_m) != {33: 200} or bad:
        phase("gym", f"FAIL: config-2 gym: finite {finite}, K1 launches by M "
                     f"{dict(rec.by_m)}; {bad}")
        return 1
    phase("gym", f"GymIntersectionEnv config 2 (traffic, density 0.5), 200 steps: finite, K1 "
                 f"once per step at 1x1 M=33, bit-equal to its plain version ({held}); "
                 f"{k1_times(rec.args, kernels, 'gym_traffic')}; median wall ms per step "
                 f"{float(np.median(wall)):.4f}; card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
