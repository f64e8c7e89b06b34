"""Throughput of the port's main path: batched env-steps/s on one card.

The counterpart of the repo's bench.py: 4096 envs x 4 agents, lidar on,
auto-reset, zero actions, and the observation of every step consumed (its
sum is accumulated on the card), so nothing is skipped. The value is the
median of BENCH_REPEATS (default 5) timed blocks of BENCH_ITERS x
BENCH_INNER steps, each block ended by ``torch.cuda.synchronize()``; the
line also carries the per-block values, their spread, the card's name and
its power limit. It refuses to run without a card.

  python -m marl_traffic_intersection_tpu_torch.bench

Env knobs: BENCH_NUM_ENVS, BENCH_NUM_AGENTS, BENCH_ITERS, BENCH_INNER,
BENCH_REPEATS. BENCH_MODE=traffic turns NPC traffic on (defaults then 1024
envs x 1 agent, as bench.py's) with BENCH_NPC_MODE (exact, serial or fast,
default fast) and BENCH_DENSITY (default 1.0). BENCH_PROFILE=1 adds a
second line from torch.profiler over BENCH_INNER steps after the timed
blocks: the card's busy share of the window and the kernels that took the
most device time per step.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

from .utils.profiling import profile_steps


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi prints them for the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bench(num_envs: int = 4096, num_agents: int = 4, iters: int = 5, inner: int = 20,
          repeats: int = 5, profile: bool = False, traffic: bool = False,
          npc_mode: str = "fast", density: float = 1.0):
    """Per-block env-steps/s, one value per repeat, and the profile (or None)."""
    from .core.env import EnvConfig, IntersectionEnv
    from .envs.vector import VectorEnv

    env = IntersectionEnv(EnvConfig(num_agents=num_agents, max_steps=10 ** 9,
                                    traffic_flow=traffic, traffic_density=density,
                                    npc_mode=npc_mode), device="cuda")
    venv = VectorEnv(env, num_envs=num_envs, seed=0)
    state, obs = venv.reset()
    actions = torch.zeros((num_envs, num_agents, 2), device=env.device)
    chk = torch.zeros((), device=env.device)
    for _ in range(inner):                       # warm-up: builds and caches
        state, out = venv.step(state, actions)
        chk += out.obs.sum()
    torch.cuda.synchronize()
    vals = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters * inner):
            state, out = venv.step(state, actions)
            chk += out.obs.sum()
        torch.cuda.synchronize()
        vals.append(num_envs * iters * inner / (time.perf_counter() - t0))
    if not torch.isfinite(chk):
        raise RuntimeError("non-finite observations")
    prof = None
    if profile:
        prof = profile_steps(lambda: venv.step(state, actions)[1].obs.sum(), inner)
    return vals, prof


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the port's numbers come from the card only")
    traffic = os.environ.get("BENCH_MODE", "default") == "traffic"
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 1024 if traffic else 4096))
    num_agents = int(os.environ.get("BENCH_NUM_AGENTS", 1 if traffic else 4))
    npc_mode = os.environ.get("BENCH_NPC_MODE", "fast")
    density = float(os.environ.get("BENCH_DENSITY", 1.0))
    vals, prof = bench(num_envs, num_agents, int(os.environ.get("BENCH_ITERS", 5)),
                       int(os.environ.get("BENCH_INNER", 20)),
                       max(int(os.environ.get("BENCH_REPEATS", 5)), 1),
                       profile=os.environ.get("BENCH_PROFILE", "0") == "1", traffic=traffic,
                       npc_mode=npc_mode, density=density)
    value = statistics.median(vals)
    metric = f"batched env-steps/s ({num_envs} envs x {num_agents} agents, lidar on)"
    if traffic:
        metric = (f"traffic-mode env-steps/s ({num_envs} envs x {num_agents} agents, density "
                  f"{density}, npc_mode={npc_mode})")
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "env-steps/s",
        "repeats": vals,
        "dispersion_pct": 100.0 * (max(vals) - min(vals)) / value,
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
    }))
    if prof is not None:
        print(json.dumps({"profile": prof}))


if __name__ == "__main__":
    main()
