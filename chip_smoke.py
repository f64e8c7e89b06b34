"""Smoke test of the PyTorch port on one NVIDIA card (H100).

  python3 chip_smoke.py

Phases, one line each; any failure exits nonzero:
  1. device   the card's name, count, and nvidia-smi's name and power limit;
              no CUDA device -> exit 1
  2. build    every CUDA source of the port (and the CPU libm shim) built with
              nvcc/g++ in parallel, with ptxas's register and spill lines
  3. libm     the glibc-faithful sinf/cosf/tanf/atan2f/hypotf kernels on 2^22
              seeded inputs, bit-equal to the same header built for this
              machine's CPU (decides); against this machine's glibc (shown)
  4. K1       the lidar kernel against its plain PyTorch version on the card,
              bit-equal, at the main path's 4096x4 shapes and on 36-slot fuzz
              shapes; kernel, plain and bound times
  5. main     VectorEnv(4096 envs x 4 agents) with a seeded 256-256 bf16
              ActorCriticMLP in the loop for 200 steps, through the kernels
              (launch counters); then 64 envs x 100 steps on the card and on
              the CPU with the same resets and actions, bit-equal
Then one JSON line of every kernel's numbers, the card line, and last the
result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
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
    sources = ["libm.cu", "lidar.cu", "libm_host.cpp"]
    started = [(s, native.start_build(s)) for s in sources]
    for s, st in started:
        native.finish_build(s, st)
    for s in sources:
        secs, log = native.BUILD_LOG.get(s, (0.0, "(already built)"))
        keep = [ln.strip() for ln in log.splitlines()
                if re.search(r"registers|spill|bytes stack", ln)]
        phase("build", f"{s}: {secs:.1f} s; " + " | ".join(keep))
    phase("build", f"all built in {time.perf_counter() - t0:.1f} s")

    from marl_traffic_intersection_tpu_torch import (ActorCriticMLP, EnvConfig,
                                                     IntersectionEnv, VectorEnv)
    from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
    from marl_traffic_intersection_tpu_torch.core.routes import default_ego_routes
    from marl_traffic_intersection_tpu_torch.ops import libm
    from marl_traffic_intersection_tpu_torch.ops.lidar_cuda import lidar_scan

    kernels = {}

    # ---- 3. libm
    rng = np.random.RandomState(0)
    axis = np.asarray([0.0, -0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 2 * np.pi,
                       -2 * np.pi, np.pi / 4], np.float32)
    x = np.concatenate([rng.uniform(-7, 7, 1 << 22).astype(np.float32), axis])
    y = np.concatenate([rng.uniform(-7, 7, 1 << 22).astype(np.float32), axis[::-1]])
    specs = {   # name: (args, bytes moved per element, f64 ops per element, library call, replaces)
        "sinf": ((x,), 8, 14, torch.sin, "marl_traffic_intersection_tpu/ops/exact_trig.py:145"),
        "cosf": ((x,), 8, 14, torch.cos, "marl_traffic_intersection_tpu/ops/exact_trig.py:162"),
        "tanf": ((x,), 8, 40, torch.tan, "marl_traffic_intersection_tpu/ops/exact_trig.py:299"),
        "atan2f": ((y, x), 12, 40, torch.atan2,
                   "marl_traffic_intersection_tpu/ops/exact_libm.py:279"),
        "hypotf": ((x * 100, y * 100), 12, 6, torch.hypot,
                   "marl_traffic_intersection_tpu/ops/exact_libm.py:188"),
    }
    glibc = os.confstr("CS_GNU_LIBC_VERSION")
    bshape = (4096, 4)    # the env's (B, N) at the main path
    for name, (args, bpe, ope, lib_fn, replaces) in specs.items():
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
            ms=cuda_ms(lambda: fn(*small), 200),
            plain_ms=host_ms(lambda: fn(*small_cpu), 20),
            bound_ms=1e3 * max(n * bpe / HBM_BYTES_PER_S, n * ope / F64_OPS_PER_S),
            bound_by="bytes" if n * bpe / HBM_BYTES_PER_S >= n * ope / F64_OPS_PER_S
            else "operations",
            library_ms=cuda_ms(lambda: lib_fn(*small), 200))
        phase("libm", f"{name}: bit-equal to the CPU build on {got.size} inputs; "
                      f"{n_glibc} differ from this machine's {glibc} (shown only); "
                      f"{kernels[name]['ms']:.4f} ms at {bshape}")

    # ---- 4. K1
    def lidar_inputs(seed, b, n, m, axis_aligned=False, lattice=False):
        r = np.random.RandomState(seed)
        sx = r.uniform(-250, 1000, (b, n)).astype(np.float32)
        sy = r.uniform(-250, 1000, (b, n)).astype(np.float32)
        sh = (r.choice(np.asarray([0, np.pi / 2, -np.pi / 2, np.pi, -np.pi], np.float32), (b, n))
              if axis_aligned else r.uniform(-np.pi, np.pi, (b, n)).astype(np.float32))
        ox = r.uniform(-50, 800, (b, m)).astype(np.float32)
        oy = r.uniform(-50, 800, (b, m)).astype(np.float32)
        oh = r.uniform(-np.pi, np.pi, (b, m)).astype(np.float32)
        if lattice:
            ox, oy = np.round(ox), np.round(oy)
            oh = r.choice(np.asarray([0.0, np.pi / 2], np.float32), (b, m))
            sx, sy = np.round(sx), np.round(sy)
        om = r.uniform(size=(b, m)) < r.uniform(0.1, 1.0, (b, 1))
        k = min(n, m)     # the egos are in the obstacle set, as in the env
        ox[:, :k], oy[:, :k], oh[:, :k], om[:, :k] = sx[:, :k], sy[:, :k], sh[:, :k], True
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (sx, sy, sh, ox, oy, oh, om)]

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
             "random 2048x1 M=36": lidar_inputs(2, 2048, 1, 36),
             "axis-aligned 2048x1 M=36": lidar_inputs(3, 2048, 1, 36, axis_aligned=True),
             "lattice 2048x1 M=36": lidar_inputs(4, 2048, 1, 36, True, True),
             "env 512x8 M=36": lidar_inputs(5, 512, 8, 36)}
    for label, args in cases.items():
        got = lidar_scan(*args)
        ref, samples = lidar_scan_ref(*args, return_samples=True)
        torch.cuda.synchronize()
        if not bits_equal(got, ref):
            diff = int((got != ref).sum())
            phase("K1", f"FAIL {label}: {diff} rays differ from lidar_scan_ref")
            return 1
        phase("K1", f"{label}: bit-equal to the plain version "
                    f"({got.numel()} rays, {int(samples.sum())} samples marched)")
    B, N, M = 4096, 4, 4
    ref, samples = lidar_scan_ref(*main_args, return_samples=True)
    ops = float(samples.sum()) * (20 + 4 * M)
    nbytes = 3 * B * N * 4 + 3 * B * M * 4 + B * M + B * N * 96 * 4
    kernels["lidar_scan"] = dict(
        name="lidar_scan", route="cuda", source=SRC + "lidar.cu",
        replaces="marl_traffic_intersection_tpu/ops/lidar_pallas.py:155",
        max_abs_err=float((lidar_scan(*main_args) - ref).abs().max()),
        ms=cuda_ms(lambda: lidar_scan(*main_args), 50),
        plain_ms=cuda_ms(lambda: lidar_scan_ref(*main_args), 5),
        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
        library_ms=None)
    k = kernels["lidar_scan"]
    phase("K1", f"4096x4 M=4: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, "
                f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}: {ops:.3e} ops, "
                f"{nbytes} bytes); launch counter {native.LAUNCHES['lidar_scan']}; card {card}")

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

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
