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
Then one JSON line of every kernel's numbers, the card line, and last the
result line {"ok": true, "device": {...}}.

Kernel times ("ms") are device times per launch: torch.profiler's self
device time of the kernel over many launches. "event_ms" is the CUDA-event
time of back-to-back calls of the wrapper, which includes the host's
dispatch whenever a launch is shorter than the wrapper's Python call.
"launch_floor_ms" (libm rows) is the device time of the smallest launch, a
torch.add of two 1-element tensors. "launches" counts the main phase's
launches, "launches_train" those of the train phase's 3 updates,
"launches_traffic" those of the traffic phase's 200 exact-mode steps.
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
import time

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

    if train_phase(dev, card, kernels):
        return 1
    if traffic_phase(dev, card, kernels):
        return 1

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def run_train(argv):
    """``train.main(argv)``, its output echoed; returns its JSON log lines and
    its profile line (None without --profile)."""
    from marl_traffic_intersection_tpu_torch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    logs, prof = [], None
    for ln in buf.getvalue().splitlines():
        phase("train", ln)
        if ln.startswith("{"):
            line = json.loads(ln)
            if "profile" in line:
                prof = line["profile"]
            elif "update" in line:
                logs.append(line)
    return logs, prof


def losses_finite(logs):
    return bool(logs) and all(np.isfinite([ln[k] for k in ("pg_loss", "v_loss", "entropy",
                                                            "approx_kl")]).all() for ln in logs)


def split_line(name, logs, prof, peak, card):
    """The rollout/update split of the logged updates after the first (warm-up)
    and before a profiled one, peak memory and the profile, as one phase line."""
    timed = logs[1:-1] if prof else logs[1:]
    roll = [ln["rollout_s"] for ln in timed]
    upd = [ln["update_s"] for ln in timed]
    steps = TRAIN_B * TRAIN_T * len(timed)
    top = [(k["name"][:60], round(k["ms_per_step"], 2), k["launches_per_step"])
           for k in (prof or {}).pop("top_kernels", [])]
    phase("train", f"{name}: rollout s {roll}, update (GAE + 16 minibatches) s {upd}; "
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
                or saved["update"] != 4 or saved["update_count"] != 4 * 16):
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
    from marl_traffic_intersection_tpu_torch.core import env as env_module
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
    k1_seen, k1_args = collections.Counter(), []
    scan = env_module.lidar_scan

    def k1_counted(*args, **kw):          # the obstacle count of each launch
        k1_seen[args[3].shape[1]] += 1
        k1_args[:] = args
        return scan(*args, **kw)

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
        k1_seen.clear()
        alive = torch.zeros((steps, B), dtype=torch.int32, device=dev)
        spawned = torch.zeros((), dtype=torch.int64, device=dev)
        env_module.lidar_scan = k1_counted
        try:
            t0 = time.perf_counter()
            for t in range(steps):
                state, out = venv.step(state, model.act(obs))
                obs = out.obs
                alive[t] = state.npc.alive.sum(1)
                spawned += out.spawned.sum()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            env_module.lidar_scan = scan
        launches = dict(native.LAUNCHES)
        stats = dict(env.npc_stats)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(obs).all())
        if obs.shape != (B, N, 127) or not finite or int(spawned) == 0:
            phase("traffic", f"FAIL {mode}: obs {tuple(obs.shape)} finite={finite}, "
                             f"{int(spawned)} NPCs spawned")
            return 1
        if dict(k1_seen) != {N + 32: steps} or launches.get("lidar_scan", 0) != steps:
            phase("traffic", f"FAIL {mode}: K1 launches by obstacle count {dict(k1_seen)} "
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
            args = list(k1_args)
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


if __name__ == "__main__":
    sys.exit(main())
