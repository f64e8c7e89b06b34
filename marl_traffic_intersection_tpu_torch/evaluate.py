"""Policy evaluation: the port's counterpart of eval.py.

Batched (``--vector B``, the default): a policy drives B auto-reset envs for
T steps on the card and the run prints one JSON line with the keys of
eval.py's vector evaluation: episodes, success and crash counts (status
transitions), mean episode length and reward, and env-steps/s.

Single-env (``--episodes N``): eval.py's loop of N episodes of one env, each
reset with the config's routes and run until it terminates, is truncated or
reaches ``--max-steps``, with eval.py's keys: success events (transitions
into SUCCESS), crash samples, the share of agents that succeeded, mean
episode length and reward. It runs on the card too unless ``--device cpu``
asks for the CPU; eval.py runs its single-env loop on the host by default.
``--policy scripted`` (this loop only) is eval.py's baseline driver: the
Stanley controller on the route table, with the state moved to the host each
step (numpy float64, as eval.py computes it).

  python -m marl_traffic_intersection_tpu_torch.evaluate --config 1 --episodes 20 --policy scripted
  python -m marl_traffic_intersection_tpu_torch.evaluate --config 3 --episodes 5 \
      --policy checkpoint --checkpoint policy_gru_multi --model gru

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

import numpy as np
import torch

from .core.constants import (STATUS_ALIVE, STATUS_CRASH_CAR, STATUS_CRASH_LINE,
                             STATUS_CRASH_WALL, STATUS_SUCCESS)
from .compat import host_state
from .core.env import EnvConfig, IntersectionEnv
from .core.npc import spawn_decision
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


def scripted_policy(obs, state=None, table=None):
    """eval.py's baseline driver. Without state: NPC-like P-steer on the
    lookahead heading error (obs[5]). With privileged state (one env of an
    ``EnvState``, or its ``compat.host_state``): Stanley controller on the
    actual route polyline (tangent heading error + cross-track), which tracks
    the tight right-turn arcs within their ~13 px inner clearance. numpy in,
    (N, 2) float32 out."""
    if state is None or table is None:
        obs = np.asarray(obs)
        theta_err = obs[..., 5] * np.pi
        steer = np.clip(theta_err * 3.0, -1, 1)
        v = obs[..., 2]
        target = np.where(np.abs(theta_err) > 0.15, 0.22, 0.4)
        throttle = np.where(v < target, 0.5,
                            np.where(v > target + 0.12, -0.3, 0.01))
        return np.stack([throttle.astype(np.float32), steer.astype(np.float32)],
                        axis=-1)

    ego = host_state(state).ego
    x, y, h, v = ego.x, ego.y, ego.heading, ego.v
    pi_, rid = ego.path_index, ego.route_id
    paths = table.paths  # (R, P, 2)

    n = x.shape[0]
    acts = np.zeros((n, 2), np.float32)
    for i in range(n):
        p = paths[rid[i]]
        k = min(int(pi_[i]) + 3, len(p) - 2)
        tx, ty = p[k + 1] - p[k]                    # screen coords, y down
        theta_path = np.arctan2(-ty, tx)            # y-up heading convention
        theta_e = (theta_path - h[i] + np.pi) % (2 * np.pi) - np.pi
        # signed cross-track in y-up frame: + means path is to the left
        dxp, dyp = x[i] - p[k][0], -(y[i] - p[k][1])
        txu, tyu = tx, -ty
        nrm = np.hypot(txu, tyu) + 1e-9
        cross = (txu * dyp - tyu * dxp) / nrm
        delta = theta_e - np.arctan2(0.35 * cross, v[i] + 1.5)
        acts[i, 1] = np.clip(delta / 0.6108652381980153, -1, 1)

        # curvature-aware cruise: slow for the upcoming 25-point window
        k2 = min(int(pi_[i]) + 25, len(p) - 2)
        t2 = p[k2 + 1] - p[k2]
        th2 = np.arctan2(-t2[1], t2[0])
        bend = abs((th2 - theta_path + np.pi) % (2 * np.pi) - np.pi)
        target = 1.8 if bend > 0.05 else 3.2
        acts[i, 0] = 0.5 if v[i] < target else (-0.3 if v[i] > target + 0.8 else 0.01)
    return acts


def _env(config: int, max_steps: int, npc_mode: str, dev):
    c = dict(CONFIGS[config])
    routes = c.pop("routes")
    env = IntersectionEnv(EnvConfig(max_steps=max_steps, npc_mode=npc_mode, **c), device=dev)
    return env, (env.table.route_ids(routes) if routes else None)


@torch.no_grad()
def episodes(config: int = 1, num_episodes: int = 10, max_steps: int = 2000,
             policy: str = "scripted", seed: int = 0, device=None, checkpoint: str = None,
             model_kind: str = "mlp", npc_mode: str = "exact") -> dict:
    """eval.py's single-env loop (its keys, plus the device): ``num_episodes``
    episodes of one env of BASELINE config ``config``."""
    dev = resolve_device(device)
    env, rids = _env(config, max_steps, npc_mode, dev)
    cfg = env.config
    if rids is None:
        rids = env.default_route_ids()
    n = cfg.num_agents
    rng = np.random.RandomState(seed)
    model = mean_fn = None
    if policy == "checkpoint":
        if checkpoint is None:
            raise ValueError("policy 'checkpoint' needs a checkpoint directory or a shipped policy")
        model, mean_fn = load_policy(checkpoint, model_kind, dev)
    elif policy == "mlp":
        torch.manual_seed(seed)
        model = ActorCriticMLP().to(dev)
        mean_fn = lambda obs: model(obs)[0]
    elif policy not in ("scripted", "random"):
        raise ValueError(f"unknown policy {policy!r}")
    gru = policy == "checkpoint" and model_kind == "gru"
    gen = torch.Generator(device=dev)
    stats = dict(success=0, crash_car=0, crash_obj=0, steps=[], reward=[], agents_succeeded=0)
    t0 = time.perf_counter()
    for ep in range(num_episodes):
        state, obs = env.reset(rids)
        gen.manual_seed(seed + ep)           # the episode's NPC spawn draws
        if gru:
            h = model.initial_hidden(1, n, device=dev)
        prev_st = np.zeros(n, np.int32)
        ever_succ = np.zeros(n, bool)
        total = 0.0
        for t in range(max_steps):
            if policy == "scripted":
                acts = torch.from_numpy(scripted_policy(None, state, env.table))[None]
            elif policy == "random":
                acts = torch.from_numpy(rng.uniform(-1, 1, (1, n, 2)).astype(np.float32))
            elif gru:
                mean, h = mean_fn(obs, h)
                acts = torch.tanh(mean)
            else:
                acts = torch.tanh(mean_fn(obs))
            spawn = spawn_decision(gen, 1, env.traffic_ids.shape[0], cfg.traffic_density,
                                   1.0 / 60.0) if cfg.traffic_flow else None
            state, out = env.step(state, acts.to(dev), spawn=spawn)
            obs = out.obs
            if gru:
                # zero memory at agent life boundaries, matching training
                h = h * (1.0 - out.done.float())[..., None]
            # one copy of what the stats read
            packed = torch.cat([out.reward[0], out.status[0].float(),
                                torch.stack([out.terminated[0], out.truncated[0]]).float()])
            packed = packed.cpu().numpy()
            total += float(packed[:n].sum())
            st = packed[n:2 * n].astype(np.int32)
            # count EVENTS (transitions into a status), not per-step samples:
            # SUCCESS persists while an agent waits for the others, and a
            # respawned agent can succeed again; each completion counts once
            succ_now = st == STATUS_SUCCESS
            stats["success"] += int((succ_now & (prev_st != STATUS_SUCCESS)).sum())
            ever_succ |= succ_now
            stats["crash_car"] += int((st == STATUS_CRASH_CAR).sum())
            stats["crash_obj"] += int(((st == STATUS_CRASH_WALL) | (st == STATUS_CRASH_LINE)).sum())
            prev_st = st
            if packed[2 * n] or packed[2 * n + 1]:
                break
        stats["steps"].append(t + 1)
        stats["reward"].append(total)
        stats["agents_succeeded"] += int(ever_succ.sum())
    secs = time.perf_counter() - t0
    return {
        "config": config,
        "episodes": num_episodes,
        "policy": policy,
        "successes": stats["success"],
        "agents_succeeded_frac": stats["agents_succeeded"] / (num_episodes * n),
        "crashes_vehicle": stats["crash_car"],
        "crashes_object": stats["crash_obj"],
        "mean_ep_len": float(np.mean(stats["steps"])),
        "mean_ep_reward": float(np.mean(stats["reward"])),
        "ms_per_step": round(1e3 * secs / sum(stats["steps"]), 3),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def evaluate(config: int = 1, num_envs: int = 1024, max_steps: int = 2000,
             policy: str = "random", seed: int = 0, device=None,
             checkpoint: str = None, model_kind: str = "mlp", npc_mode: str = "exact") -> dict:
    dev = resolve_device(device)
    env, rids = _env(config, max_steps, npc_mode, dev)
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
    ap.add_argument("--vector", type=int, default=None, metavar="B",
                    help="batched evaluation of B auto-reset envs (default 1024)")
    ap.add_argument("--episodes", type=int, default=None, metavar="N",
                    help="eval.py's single-env loop of N episodes instead")
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--policy", choices=["random", "mlp", "checkpoint", "scripted"],
                    default=None, help="default: random batched, scripted single-env")
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
    if args.episodes is not None:
        if args.vector is not None:
            ap.error("--episodes (single-env loop) and --vector (batched) exclude each other")
        print(json.dumps(episodes(args.config, args.episodes, args.max_steps,
                                  args.policy or "scripted", args.seed, args.device,
                                  args.checkpoint, args.model, args.npc_mode)))
        return
    if args.policy == "scripted":
        ap.error("--policy scripted runs in the single-env loop (--episodes N): the Stanley "
                 "driver is host-side")
    print(json.dumps(evaluate(args.config, args.vector or 1024, args.max_steps,
                              args.policy or "random", args.seed, args.device, args.checkpoint,
                              args.model, args.npc_mode)))


if __name__ == "__main__":
    main()
