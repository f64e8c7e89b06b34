"""Batched policy evaluation: the port's counterpart of ``eval.py --vector``.

A policy drives B auto-reset envs for T steps on the card and the run prints
one JSON line with the keys of eval.py's vector evaluation: episodes,
success and crash counts (status transitions), mean episode length and
reward, and env-steps/s.

  python -m marl_traffic_intersection_tpu_torch.evaluate --config 3 --vector 4096
  python -m marl_traffic_intersection_tpu_torch.evaluate --config 4 --npc-mode fast
  python -m marl_traffic_intersection_tpu_torch.evaluate --policy mlp --seed 0

  python -m marl_traffic_intersection_tpu_torch.evaluate --policy checkpoint \
      --checkpoint runs/ppo --model mlp
  python -m marl_traffic_intersection_tpu_torch.evaluate --config 4 --vector 4096 \
      --policy checkpoint --checkpoint artifacts/policy_gru_multi --model gru

Policies: ``random`` (uniform actions), ``mlp`` (the 256-256 ActorCriticMLP,
weights made from ``--seed``), or ``checkpoint``: the deterministic action
``tanh(mean)`` of a policy of family ``--model`` read by
``utils/checkpoint.py::load_policy`` from ``--checkpoint``, a directory saved
by the port's ``train`` (``train_sac`` for ``--model sac``) or a shipped
policy (``artifacts/policy_mlp_cfg1``, or its bare name). The GRU's hidden
state is zeroed at each agent's life boundary, as in training. BASELINE
configs 2 and 4 run NPC traffic in ``--npc-mode`` (exact, serial or fast;
core/npc.py), which the JSON line reports.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .core.constants import (STATUS_ALIVE, STATUS_CRASH_CAR, STATUS_CRASH_LINE,
                             STATUS_CRASH_WALL, STATUS_SUCCESS)
from .core.env import EnvConfig, IntersectionEnv
from .device import resolve_device
from .envs.vector import VectorEnv
from .models import MODEL_FAMILIES
from .models.actor_critic import ActorCriticMLP
from .utils.checkpoint import load_policy

CONFIGS = {
    1: dict(num_agents=1, traffic_flow=False, routes=[("IN_6", "OUT_2")]),
    2: dict(num_agents=1, traffic_flow=True, traffic_density=0.5,
            routes=[("IN_6", "OUT_2")]),
    3: dict(num_agents=3, traffic_flow=False, use_team_reward=True,
            routes=[("IN_6", "OUT_2"), ("IN_1", "OUT_7"), ("IN_4", "OUT_7")]),
    4: dict(num_agents=8, traffic_flow=True, traffic_density=1.0, routes=None),
}


def evaluate(config: int = 1, num_envs: int = 1024, max_steps: int = 2000,
             policy: str = "random", seed: int = 0, device=None,
             checkpoint: str = None, model_kind: str = "mlp", npc_mode: str = "exact") -> dict:
    dev = resolve_device(device)
    c = dict(CONFIGS[config])
    routes = c.pop("routes")
    env = IntersectionEnv(EnvConfig(max_steps=max_steps, npc_mode=npc_mode, **c), device=dev)
    rids = env.table.route_ids(routes) if routes else None
    venv = VectorEnv(env, num_envs=num_envs, route_pool=rids, seed=seed)
    n = env.config.num_agents
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    h = None                  # the GRU's hidden state
    if policy == "mlp":
        torch.manual_seed(seed)
        model = ActorCriticMLP().to(dev)
        act_fn = model.act
    elif policy == "checkpoint":
        if checkpoint is None:
            raise ValueError("policy 'checkpoint' needs a checkpoint directory or a shipped policy")
        model, mean_fn = load_policy(checkpoint, model_kind, dev)
        if model_kind == "gru":
            h = model.initial_hidden(num_envs, n, device=dev)

            def act_fn(obs):
                nonlocal h
                mean, h = mean_fn(obs, h)
                return torch.tanh(mean)
        else:
            act_fn = lambda obs: torch.tanh(mean_fn(obs))
    elif policy == "random":
        act_fn = lambda obs: torch.rand((num_envs, n, 2), generator=gen, device=dev) * 2 - 1
    else:
        raise ValueError(f"unknown policy {policy!r}")

    state, obs = venv.reset()
    prev_st = torch.zeros((num_envs, n), dtype=torch.int32, device=dev)
    ep_len = torch.zeros((num_envs,), dtype=torch.int32, device=dev)
    ep_rew = torch.zeros((num_envs,), dtype=torch.float32, device=dev)
    sums = torch.zeros(6, dtype=torch.float64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(max_steps):
        state, out = venv.step(state, act_fn(obs))
        obs = out.obs
        st = out.status
        ep_done = out.terminated | out.truncated
        if h is not None:     # zero memory at agent life boundaries, matching training
            h = h * (1.0 - (out.done | ep_done[:, None]).float())[..., None]
        ep_len = ep_len + 1
        ep_rew = ep_rew + out.reward.sum(-1)
        sums += torch.stack([
            ((st == STATUS_SUCCESS) & (prev_st != STATUS_SUCCESS)).sum(),
            (st == STATUS_CRASH_CAR).sum(),
            ((st == STATUS_CRASH_WALL) | (st == STATUS_CRASH_LINE)).sum(),
            ep_done.sum(),
            torch.where(ep_done, ep_len, 0).sum(),
            torch.where(ep_done, ep_rew, 0.0).sum(),
        ]).double()
        ep_len = torch.where(ep_done, 0, ep_len)
        ep_rew = torch.where(ep_done, 0.0, ep_rew)
        # a reset env starts its next transition from ALIVE
        prev_st = torch.where(ep_done[:, None], STATUS_ALIVE, st).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    succ, cc, co, eps, len_sum, rew_sum = sums.tolist()
    eps = max(int(eps), 1)
    return {
        "config": config, "vector": num_envs, "policy": policy,
        "npc_mode": env.config.npc_mode if env.config.traffic_flow else None,
        "episodes": eps, "successes": int(succ),
        "success_rate_per_episode": round(succ / eps, 4),
        "crashes_vehicle": int(cc), "crashes_object": int(co),
        "mean_ep_len": round(len_sum / eps, 1),
        "mean_ep_reward": round(rew_sum / eps, 3),
        "env_steps": num_envs * max_steps,
        "env_steps_per_s": round(num_envs * max_steps / secs, 1),
        "secs": round(secs, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=1, choices=sorted(CONFIGS))
    ap.add_argument("--vector", type=int, default=1024, metavar="B")
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--policy", choices=["random", "mlp", "checkpoint"], default="random")
    ap.add_argument("--checkpoint", default=None,
                    help="with --policy checkpoint: a directory saved by the port's train "
                         "or train_sac, or a shipped policy (artifacts/policy_mlp_cfg1)")
    ap.add_argument("--model", default="mlp", choices=sorted(MODEL_FAMILIES),
                    help="with --policy checkpoint: the checkpoint's model family")
    ap.add_argument("--npc-mode", choices=["exact", "serial", "fast"], default="exact",
                    help="NPC traffic semantics (traffic configs only): the reference's "
                         "sequential order (exact, or its direct transcription serial) or a "
                         "synchronous approximation (fast)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' to ask for it")
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.config, args.vector, args.max_steps, args.policy,
                              args.seed, args.device, args.checkpoint, args.model,
                              args.npc_mode)))


if __name__ == "__main__":
    main()
