"""Multi-process dry run of every model family on a ``(data, model)`` mesh:
the port's counterpart of the repo's ``__graft_entry__.py::dryrun_multichip``.

  python -m marl_traffic_intersection_tpu_torch.dryrun --n 4 --device cpu   # gloo
  python -m marl_traffic_intersection_tpu_torch.dryrun --n 1                # NCCL, one card

``dryrun_multichip(n, device)`` spawns ``n`` processes joined in one process
group (gloo on the CPU, NCCL on cards, rank r on card ``r % cards``) and, in
every one of them, runs one sharded train step with the JAX helpers' tiny
shapes (2 agents, 16 max steps, ``2 * n_data`` envs, rollout 4, 2
minibatches, 1 epoch; SAC: batch 16, ring 512, warmup 8, 2 steps a call):
each PPO family (mlp, attention, conv, gru, central) at every tp of 1, 2, 4
that divides n, then SAC at each tp, then mlp, gru and SAC with NPC traffic
(density 1.0, 8 slots). A step whose losses are not finite raises. It
returns (and prints) one ``dryrun ok: ...`` line a step.

``spawn`` is the process-group launcher it uses, for tests too.
"""
from __future__ import annotations

import argparse
import math
import os
import socket
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FAMILIES = ("mlp", "attention", "conv", "gru", "central")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, backend: str, device: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), device: str = "cpu",
          backend: Optional[str] = None, timeout: float = 600.0) -> None:
    """Run ``fn(device, *args)`` in ``world`` new processes joined in one
    process group on a free local port: gloo for ``device="cpu"``, NCCL for
    ``"cuda"`` unless ``backend`` says otherwise. ``fn`` must be importable
    (the processes start from a fresh interpreter). Raises if a process
    raises, or, after terminating them, if they outlast ``timeout`` seconds."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = mp.start_processes(_rank_main, args=(fn, world, _free_port(), backend, device, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} processes of {fn.__name__} outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


def _env(dev, n_data: int, traffic: bool):
    from .core.env import EnvConfig, IntersectionEnv
    from .envs.vector import VectorEnv
    env = IntersectionEnv(EnvConfig(num_agents=2, max_steps=16, traffic_flow=traffic,
                                    traffic_density=1.0, max_npcs=8), device=dev)
    return VectorEnv(env, num_envs=2 * n_data)


def _finite(metrics, keys, where) -> None:
    bad = {k: metrics[k] for k in keys if not math.isfinite(metrics[k])}
    if bad:
        raise RuntimeError(f"{where}: losses not finite {bad}")


def one_family(dev, mesh, kind: str, traffic: bool = False) -> dict:
    """One sharded PPO (recurrent PPO for 'gru') train step of ``kind`` on
    ``mesh``; its metrics, averaged over the data ranks."""
    from .models import make_model
    from .parallel.mesh import data_axis
    from .parallel.ppo import PPOConfig, PPOLearner, read_metrics
    from .parallel.recurrent_ppo import RecurrentPPOLearner

    venv = _env(dev, data_axis(mesh).size, traffic)
    cfg = PPOConfig(rollout_len=4, num_minibatches=2, update_epochs=1)
    learner = (RecurrentPPOLearner if kind == "gru" else PPOLearner)(venv, make_model(kind), cfg)
    ts = learner.init()
    carry = list(venv.reset()) + ([learner.initial_hidden()] if kind == "gru" else [])
    step, shard_ts, shard_env = learner.distributed(mesh, kind)
    ts = shard_ts(ts)
    ts, *carry, metrics = step(ts, *shard_env(*carry))
    m = read_metrics(metrics, mesh)
    _finite(m, ("pg_loss", "v_loss"), kind)
    return m


def sac_family(dev, mesh, traffic: bool = False) -> dict:
    """One sharded SAC train call (2 env steps and updates) on ``mesh``."""
    from .parallel.mesh import data_axis
    from .parallel.ppo import read_metrics
    from .parallel.sac import SACConfig, SACLearner

    venv = _env(dev, data_axis(mesh).size, traffic)
    learner = SACLearner(venv, SACConfig(batch_size=16, buffer_capacity=512, warmup=8,
                                         steps_per_call=2))
    ts = learner.init()
    state, obs = venv.reset()
    step, shard_ts, shard_env = learner.distributed(mesh)
    ts = shard_ts(ts)
    ts, state, obs, metrics = step(ts, *shard_env(state, obs))
    m = read_metrics(metrics, mesh)
    _finite(m, ("q_loss", "actor_loss"), "sac")
    return m


def _sweep(dev, out_path: str) -> None:
    from .parallel.mesh import make_mesh

    n = dist.get_world_size()
    tps = [t for t in (1, 2, 4) if n % t == 0]
    meshes = {tp: make_mesh(n // tp, tp) for tp in tps}
    lines = []

    def ok(name, tp):
        lines.append(f"dryrun ok: {name} dp={n // tp} tp={tp}")

    for kind in FAMILIES:
        for tp in tps:
            one_family(dev, meshes[tp], kind)
            ok(kind, tp)
    for tp in tps:
        sac_family(dev, meshes[tp])
        ok("sac", tp)
    # traffic: the rollout's NPC pool narrowed per rank, and the learners
    # with their own rebinding paths (feed-forward, recurrent, SAC's ring)
    for kind in ("mlp", "gru"):
        for tp in tps:
            one_family(dev, meshes[tp], kind, traffic=True)
            ok(f"{kind}+traffic", tp)
    for tp in tps:
        sac_family(dev, meshes[tp], traffic=True)
        ok("sac+traffic", tp)
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            f.write("\n".join(lines))


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: Optional[str] = None,
                     timeout: float = 900.0) -> List[str]:
    """Every family's sharded train step at every tp in (1, 2, 4) dividing
    ``n_devices``, in ``n_devices`` processes (see the module docstring);
    returns and prints the ``dryrun ok`` lines."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lines")
        spawn(_sweep, n_devices, (out,), device=device, backend=backend, timeout=timeout)
        with open(out) as f:
            lines = f.read().splitlines()
    for ln in lines:
        print(ln)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1, help="processes (ranks)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, help="default: nccl on cards, gloo on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)


if __name__ == "__main__":
    main()
