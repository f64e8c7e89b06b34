"""PPO training on one card: the port's counterpart of the repo's train.py.

  python -m marl_traffic_intersection_tpu_torch.train --num-envs 4096 --agents 4 --updates 50
  python -m marl_traffic_intersection_tpu_torch.train --model attention
  # curriculum: easy -> hard stages, the policy and optimizer carried across
  python -m marl_traffic_intersection_tpu_torch.train --curriculum "agents=1@40;agents=2@40;agents=4@80"
  python -m marl_traffic_intersection_tpu_torch.train --device cpu --num-envs 8 --updates 2
  # NPC traffic (core/npc.py); a curriculum may switch it on and raise the density
  python -m marl_traffic_intersection_tpu_torch.train --traffic --density 1.0 --npc-mode exact
  python -m marl_traffic_intersection_tpu_torch.train --curriculum "density=0.2,traffic=1@50;density=1.0@100"

It runs on the CUDA card unless ``--device cpu`` asks for the CPU, and raises
without a card otherwise. Metrics stay on the device between log points; each
log point is one JSON line with train.py's keys, the device's name, and the
seconds of the update's rollout and of its GAE + optimisation (``rollout_s``,
``update_s``: at a log point the loop waits for the device before, between
and after the two). ``--profile TRACE`` profiles the last update with
torch.profiler, prints its device busy share, launches and top kernels as a
JSON line and writes its Chrome trace to TRACE.

``--model gru`` trains the recurrent family with the truncated-BPTT learner
(parallel/recurrent_ppo.py); its hidden state joins the rollout's carries.

``--checkpoint DIR`` saves a full training snapshot there at the end (and
every ``--checkpoint-every`` updates): model and Adam state, the update
counters, the env state and observation (and the GRU's hidden state), and
the state of every torch.Generator (action noise, minibatch permutations,
route and NPC spawn draws), so a resumed run continues the uninterrupted one
exactly. Restarting
the same command auto-resumes from DIR and counts the restored updates toward
``--updates``; an explicit ``--resume DIR`` is a warm start whose restored
counter is an offset, and ``--updates`` more run on top of it. ``--resume``
also takes a shipped policy (``policy_attn_cfg1``, ``artifacts/policy_attn_cfg1``
or its ``.npz`` export), as train.py resumes an orbax store: its weights, its
Adam moments and step count (utils/checkpoint.py::load_train_state), and its
update counter as the offset. The store must be of the ``--model`` family.
Every resume starts the minibatch counter that ``--critic-warmup`` reads from
0, as train.py does, so a resumed run masks the actor for its first
``--critic-warmup`` updates; the optimizer takes the stage's ``--lr``.

  # the fine-tune that made policy_attn_multi
  python -m marl_traffic_intersection_tpu_torch.train --model attention \
      --resume artifacts/policy_attn_cfg1 --agents 4 --updates 600 --ent-coef 0.001 --lr 1e-4
  # MAPPO from a trained mlp (warm_start_central.py writes the snapshot)
  python -m marl_traffic_intersection_tpu_torch.warm_start_central \
      --source policy_mlp_cfg1 --out runs/central_warm --agents 4
  python -m marl_traffic_intersection_tpu_torch.train --model central \
      --resume runs/central_warm --critic-warmup 100

``--lidar-impl`` is accepted for train.py's sake: every choice runs kernel
K1 (the JAX package's lidar variants are bit-identical). Not here yet:
train.py's ``--tp`` and ``--distributed`` (multi-GPU, ROADMAP queue 1 item
14) and ``--tb`` (TensorBoard logging, item 15).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .core.env import EnvConfig, IntersectionEnv, RewardParams
from .device import resolve_device
from .envs.normalize import RewardNormVecEnv
from .envs.vector import VectorEnv
from .models import make_model
from .parallel.ppo import PPOConfig, PPOLearner, read_metrics
from .parallel.recurrent_ppo import RecurrentPPOLearner
from .utils.checkpoint import (checkpoint_exists, env_state_from_dict, env_state_to_dict,
                               load_train_state, resolve_policy, restore_checkpoint,
                               save_checkpoint)
from .utils.profiling import StepsPerSecond, profile_steps


def parse_curriculum(spec: str) -> list:
    """'key=val[,key=val]@updates;...' -> [(overrides dict, updates)].

    Supported keys: agents, density, traffic, ent_coef, lr, rollout_len.
    """
    stages = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        body, _, upd = part.rpartition("@")
        if not body:
            raise ValueError(f"curriculum stage needs 'key=val@updates': {part!r}")
        overrides = {}
        for kv in body.split(","):
            k, _, v = kv.partition("=")
            k = k.strip().replace("-", "_")
            if k == "agents":
                overrides["agents"] = int(v)
            elif k == "density":
                overrides["density"] = float(v)
            elif k == "traffic":
                overrides["traffic"] = v.strip() in ("1", "true", "True")
            elif k == "ent_coef":
                overrides["ent_coef"] = float(v)
            elif k == "lr":
                overrides["lr"] = float(v)
            elif k == "rollout_len":
                overrides["rollout_len"] = int(v)
            else:
                raise ValueError(f"unknown curriculum key {k!r}")
        stages.append((overrides, int(upd)))
    return stages


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--traffic", action="store_true", help="NPC traffic flow")
    ap.add_argument("--density", type=float, default=0.5, help="NPC spawn rate per second")
    ap.add_argument("--npc-mode", choices=["exact", "fast"], default="exact",
                    help="NPC update semantics: the reference's sequential order, bit for "
                         "bit, or a synchronous approximation")
    ap.add_argument("--lidar-impl", choices=["auto", "xla", "interval", "pallas"],
                    default="auto", help="accepted for train.py's sake; all run kernel K1")
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--rollout-len", type=int, default=64)
    ap.add_argument("--model", choices=["mlp", "attention", "conv", "gru", "central"],
                    default="mlp")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--critic-warmup", type=int, default=0,
                    help="updates with the actor loss masked while a fresh critic fits")
    ap.add_argument("--norm-reward", action="store_true",
                    help="running discounted-return reward normalization")
    ap.add_argument("--curriculum", default=None,
                    help="staged training: 'key=val[,k=v]@updates;...' (keys: agents, "
                         "density, traffic, ent_coef, lr, rollout_len); --updates is "
                         "ignored when set")
    ap.add_argument("--routes", default=None,
                    help="restrict ego route sampling to a fixed pool, e.g. "
                         "'IN_6:OUT_2,IN_1:OUT_7' (default: all mapped routes)")
    ap.add_argument("--reward", default=None,
                    help="override reward knobs, e.g. 'k_co=-20,k_prog=5' "
                         "(fields of core.env.RewardParams)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); 'cpu' to ask for it")
    ap.add_argument("--checkpoint", default=None, help="directory of the training snapshot")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="also save every K updates (fault tolerance)")
    ap.add_argument("--resume", default=None,
                    help="warm start: restore the model, optimizer and update counter from "
                         "a checkpoint of this train or a shipped policy (policy_mlp_cfg1)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="read the metrics from the device every K updates; between "
                         "log points the loop does not wait for the device")
    ap.add_argument("--profile", default=None, metavar="TRACE",
                    help="profile the last update with torch.profiler: print its device "
                         "busy share, launches and top kernels, and write its Chrome "
                         "trace to TRACE (.json or .json.gz)")
    args = ap.parse_args(argv)
    args.log_every = max(1, args.log_every)
    recurrent = args.model == "gru"

    dev = resolve_device(args.device)
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({dev_name})")

    stages = parse_curriculum(args.curriculum) if args.curriculum else [({}, args.updates)]
    model = make_model(args.model, seed=args.seed)
    reward = None
    if args.reward:
        kv = dict(p.split("=") for p in args.reward.split(","))
        reward = RewardParams(**{k: float(np.float32(v)) for k, v in kv.items()})

    ts, learner, carry = None, None, None
    start_update = 0
    # Preemption resilience: when the --checkpoint directory already holds a
    # snapshot and no --resume was given, continue from it; restarting the
    # same command after a kill finishes what it asked for.
    auto_resumed = False
    if not args.resume and args.checkpoint and checkpoint_exists(args.checkpoint):
        args.resume = args.checkpoint
        auto_resumed = True
        print(f"auto-resuming from existing checkpoint {args.checkpoint}")
    resume = None
    if args.resume:
        if resolve_policy(args.resume)[0] == "export":
            store = load_train_state(args.resume, args.model, model=model)
            resume = {"model": store.model.state_dict(),
                      "optimizer": store.optimizer.state_dict(), "update": store.update}
        else:
            resume = restore_checkpoint(args.resume)
        start_update = int(resume["update"])

    def save(u):
        if not args.checkpoint:
            return
        snapshot = {
            "model": ts.model.state_dict(), "optimizer": ts.optimizer.state_dict(),
            "update": u, "update_count": ts.update_count,
            "env_state": env_state_to_dict(carry[0]), "obs": carry[1],
            "generators": {"noise": learner.noise_generator.get_state(),
                           "perm": learner.perm_generator.get_state(),
                           "routes": learner.env.generator.get_state()}}
        if recurrent:
            snapshot["h"] = carry[2]
        save_checkpoint(args.checkpoint, snapshot)
        print(f"saved {args.checkpoint} @ update {u}")

    # Budget: an auto-resume counts the restored updates toward the absolute
    # budget; an explicit --resume is a warm start and runs the full budget
    # on top of the restored counter.
    stage_lo = 0 if auto_resumed else start_update
    for stage_idx, (ov, updates) in enumerate(stages):
        stage_hi = stage_lo + updates
        if start_update >= stage_hi:
            stage_lo = stage_hi         # stage fully covered by the resumed counter
            continue
        agents = ov.get("agents", args.agents)
        density = ov.get("density", args.density)
        traffic = ov.get("traffic", args.traffic)
        ent_coef = ov.get("ent_coef", args.ent_coef)
        lr = ov.get("lr", args.lr)
        rollout_len = ov.get("rollout_len", args.rollout_len)

        # a stage builds its own env, so one that changes traffic or density
        # starts from fresh states
        env = IntersectionEnv(EnvConfig(num_agents=agents, traffic_flow=traffic,
                                        traffic_density=density, max_steps=2000,
                                        npc_mode=args.npc_mode, lidar_impl=args.lidar_impl),
                              reward=reward, device=dev)
        route_pool = None
        if args.routes:
            route_pool = env.table.route_ids([tuple(p.split(":")) for p in args.routes.split(",")])
        venv = VectorEnv(env, num_envs=args.num_envs, route_pool=route_pool,
                         seed=args.seed + 1 + stage_idx)
        if args.norm_reward:
            venv = RewardNormVecEnv(venv)
        learner_cls = RecurrentPPOLearner if recurrent else PPOLearner
        prev, learner = learner, learner_cls(venv, model, PPOConfig(
            rollout_len=rollout_len, lr=lr, ent_coef=ent_coef,
            critic_warmup=args.critic_warmup), seed=args.seed + 2)

        if ts is None:
            ts = learner.init()
            if resume is not None:
                ts.model.load_state_dict(resume["model"])
                ts.optimizer.load_state_dict(resume["optimizer"])
                for group in ts.optimizer.param_groups:
                    group["lr"] = lr
                # update_count (the critic warm-up's clock) restarts at 0, as
                # train.py's resume keeps learner.init's counter
                print(f"resumed from {args.resume} at update {start_update}")
        else:
            # the policy, Adam's moments and the generators carry over; the
            # stage's learning rate applies from here on
            for group in ts.optimizer.param_groups:
                group["lr"] = lr
            learner.noise_generator.set_state(prev.noise_generator.get_state())
            learner.perm_generator.set_state(prev.perm_generator.get_state())

        if len(stages) > 1:
            print(json.dumps({"stage": stage_idx, "agents": agents, "traffic": traffic,
                              "density": density, "ent_coef": ent_coef, "lr": lr,
                              "updates": updates}))

        # the rollout's carries: env state, observation [, GRU hidden state]
        carry = list(venv.reset()) + ([learner.initial_hidden()] if recurrent else [])
        if resume is not None and "env_state" in resume and start_update > stage_lo:
            # mid-stage full snapshot: restore the rollout's carries so the
            # resumed run continues the uninterrupted one exactly
            carry[:2] = env_state_from_dict(resume["env_state"], dev), resume["obs"].to(dev)
            if recurrent:
                carry[2] = resume["h"].to(dev)
            gens = resume["generators"]
            learner.noise_generator.set_state(gens["noise"])
            learner.perm_generator.set_state(gens["perm"])
            venv.generator.set_state(gens["routes"])     # routes and NPC spawns
            resume = None

        meter = StepsPerSecond(steps_per_tick=args.num_envs * rollout_len)
        last = stage_hi - 1
        t_log = time.perf_counter()
        last_log_u = start_update - 1
        for u in range(start_update, stage_hi):
            log_point = (u - start_update) % args.log_every == 0 or u == last
            split = {} if log_point else None
            if args.profile and u == last and stage_idx == len(stages) - 1:
                out = []
                prof = profile_steps(
                    lambda: out.append(learner.train_step(ts, *carry, split)), 1,
                    trace=args.profile)
                ts, *carry, metrics = out[0]
                prof["top_kernels"] = prof["top_kernels"][:6]
                print(json.dumps({"profile": prof}), flush=True)
            else:
                ts, *carry, metrics = learner.train_step(ts, *carry, split)
            if log_point:
                m = read_metrics(metrics)      # one copy from the device
                meter.tick()
                now = time.perf_counter()
                print(json.dumps({
                    "update": u,
                    "secs": round((now - t_log) / (u - last_log_u), 3),
                    "env_steps_per_s": round(meter.value, 1),
                    **{k: round(v, 5) for k, v in m.items()},
                    **{k: round(v, 4) for k, v in split.items()},
                    "device": dev_name}), flush=True)
                t_log, last_log_u = now, u
            else:
                meter.tick()
            if args.checkpoint_every and (u + 1) % args.checkpoint_every == 0:
                save(u + 1)
        start_update = stage_hi
        stage_lo = stage_hi

    if ts is None:
        print("nothing to do: checkpoint already covers all updates")
        return
    save(start_update)
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


if __name__ == "__main__":
    main()
