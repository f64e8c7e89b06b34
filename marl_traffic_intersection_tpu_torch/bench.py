"""Throughput of the port's main path: batched env-steps/s on one card.

The counterpart of the repo's bench.py: 4096 envs x 4 agents, lidar on,
auto-reset, zero actions, and the observation of every step consumed (its
sum is accumulated on the card), so nothing is skipped. As bench.py times a
jitted scan of the step, this times ``VectorEnv.jit_step()``, the step
replayed as CUDA graphs (utils/graphs.py); with BENCH_MODE=traffic, the
graphs of the step's segments, the host reading the NPC width and steering
the exact NPC loops between them (envs/vector.py). The value is the
median of BENCH_REPEATS (default 5) timed blocks of BENCH_ITERS x
BENCH_INNER steps, each block ended by ``torch.cuda.synchronize()``; the
line also carries the per-block values, their spread, the card's name and
its power limit. It refuses to run without a card.

  python -m marl_traffic_intersection_tpu_torch.bench

As in bench.py, ``vs_baseline`` is the value over a pinned reference rate,
``baseline_ref_steps_per_s``: the single-instance C++ reference's steps/s
that BASELINE.json's ``measured_reference`` holds for this configuration
(``no_traffic_agents<N>`` or ``traffic_d<density>``), read from the
repo's root. Where it holds none, bench.py times the reference's C++ build
and falls back to the reference's 60 FPS design rate when it cannot; that
build is not part of the port, so the port falls back at once: the
denominator is then 60.0. For the same reason BENCH_RETIME_REF=1, which
asks bench.py to re-time that build, is refused. The fields are rounded as
bench.py rounds them.

Env knobs: BENCH_NUM_ENVS, BENCH_NUM_AGENTS, BENCH_ITERS, BENCH_INNER,
BENCH_REPEATS. BENCH_MODE=traffic turns NPC traffic on (defaults then 1024
envs x 1 agent, as bench.py's) with BENCH_NPC_MODE (exact, serial or fast,
default fast), BENCH_NPC_CLEANUP (the exact mode's slot or wave schedule,
default slot; the metric names it when it is not slot) and BENCH_DENSITY
(default 1.0). The port's step is always the exact float chain (core/env.py's
``EnvConfig``), so its metric always carries bench.py's ", exact_trig"
label. BENCH_PROFILE=1 adds a second line from torch.profiler over
BENCH_INNER steps after the timed blocks: the card's busy share of the
window and the kernels that took the most device time per step.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

from .utils.profiling import profile_steps

BASELINE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "BASELINE.json")
DESIGN_RATE = 60.0      # the reference's real-time design rate (steps/s): the fallback


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi prints them for the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bench(num_envs: int = 4096, num_agents: int = 4, iters: int = 5, inner: int = 20,
          repeats: int = 5, profile: bool = False, traffic: bool = False,
          npc_mode: str = "fast", density: float = 1.0, npc_cleanup: str = "slot"):
    """Per-block env-steps/s, one value per repeat, and the profile (or None)."""
    from .core.env import EnvConfig, IntersectionEnv
    from .envs.vector import VectorEnv

    env = IntersectionEnv(EnvConfig(num_agents=num_agents, max_steps=10 ** 9,
                                    traffic_flow=traffic, traffic_density=density,
                                    npc_mode=npc_mode, npc_cleanup=npc_cleanup),
                         device="cuda")
    venv = VectorEnv(env, num_envs=num_envs, seed=0)
    step = venv.jit_step()
    state, obs = venv.reset()
    actions = torch.zeros((num_envs, num_agents, 2), device=env.device)
    chk = torch.zeros((), device=env.device)
    for _ in range(inner):          # warm-up: builds, caches and the graph's capture
        state, out = step(state, actions)
        chk += out.obs.sum()
    torch.cuda.synchronize()
    vals = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters * inner):
            state, out = step(state, actions)
            chk += out.obs.sum()
        torch.cuda.synchronize()
        vals.append(num_envs * iters * inner / (time.perf_counter() - t0))
    if not torch.isfinite(chk):
        raise RuntimeError("non-finite observations")
    prof = None
    if profile:
        prof = profile_steps(lambda: step(state, actions)[1].obs.sum(), inner)
    return vals, prof


def reference_rate(traffic: bool, density: float, num_agents: int,
                   path: str = BASELINE) -> float:
    """The denominator of ``vs_baseline`` (see the module docstring): the
    pinned reference rate for this configuration, else DESIGN_RATE."""
    try:
        with open(path) as f:
            pinned = json.load(f).get("measured_reference", {})
    except (OSError, ValueError):
        pinned = {}
    key = f"traffic_d{density}" if traffic else f"no_traffic_agents{num_agents}"
    return float(pinned[key]) if pinned.get(key) is not None else DESIGN_RATE


def metric_name(num_envs: int, num_agents: int, traffic: bool = False, npc_mode: str = "fast",
                density: float = 1.0, npc_cleanup: str = "slot") -> str:
    """The ``metric`` of the JSON line, labelled as bench.py labels its own
    exact-trig run, since that is the step the port runs."""
    if traffic:
        metric = (f"traffic-mode env-steps/s ({num_envs} envs x {num_agents} agents, density "
                  f"{density}, npc_mode={npc_mode}"
                  + (f", npc_cleanup={npc_cleanup}" if npc_cleanup != "slot" else "") + ")")
    else:
        metric = f"batched env-steps/s ({num_envs} envs x {num_agents} agents, lidar on)"
    return metric + ", exact_trig"


def result_line(metric: str, vals, ref: float) -> dict:
    """The JSON line but for the card's fields: the median of ``vals``, the
    blocks, their spread, ``vs_baseline`` and ``baseline_ref_steps_per_s``,
    each rounded as bench.py rounds it."""
    value = statistics.median(vals)
    return {"metric": metric, "value": round(value, 1), "unit": "env-steps/s",
            "vs_baseline": round(value / ref, 2), "repeats": [round(v, 1) for v in vals],
            "dispersion_pct": round(100.0 * (max(vals) - min(vals)) / value, 2),
            "baseline_ref_steps_per_s": round(float(ref), 1)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the port's numbers come from the card only")
    if os.environ.get("BENCH_RETIME_REF", "0") == "1":
        raise SystemExit("bench: BENCH_RETIME_REF=1 asks to re-time the C++ reference, "
                         "which is not part of the port")
    traffic = os.environ.get("BENCH_MODE", "default") == "traffic"
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 1024 if traffic else 4096))
    num_agents = int(os.environ.get("BENCH_NUM_AGENTS", 1 if traffic else 4))
    density = float(os.environ.get("BENCH_DENSITY", 1.0))
    knobs = dict(traffic=traffic, npc_mode=os.environ.get("BENCH_NPC_MODE", "fast"),
                 density=density, npc_cleanup=os.environ.get("BENCH_NPC_CLEANUP", "slot"))
    vals, prof = bench(num_envs, num_agents, int(os.environ.get("BENCH_ITERS", 5)),
                       int(os.environ.get("BENCH_INNER", 20)),
                       max(int(os.environ.get("BENCH_REPEATS", 5)), 1),
                       profile=os.environ.get("BENCH_PROFILE", "0") == "1", **knobs)
    ref = reference_rate(traffic, density, num_agents)
    line = result_line(metric_name(num_envs, num_agents, **knobs), vals, ref)
    print(json.dumps({**line, "device": torch.cuda.get_device_name(0), "card": card_line()}))
    if prof is not None:
        print(json.dumps({"profile": prof}))


if __name__ == "__main__":
    main()
