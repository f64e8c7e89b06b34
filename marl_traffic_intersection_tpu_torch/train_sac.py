"""Off-policy SAC training on one card: the port's counterpart of the repo's
train_sac.py (learner: parallel/sac.py).

  python -m marl_traffic_intersection_tpu_torch.train_sac --num-envs 256 --agents 2 --calls 200
  python -m marl_traffic_intersection_tpu_torch.train_sac --traffic --density 0.5 --num-envs 512
  # seed the replay ring with a shipped PPO policy's transitions
  python -m marl_traffic_intersection_tpu_torch.train_sac --demo artifacts/policy_mlp_multi \\
      --demo-model mlp --demo-steps 16
  python -m marl_traffic_intersection_tpu_torch.train_sac --device cpu --num-envs 4 --calls 2

Each call runs ``--steps-per-call`` x [env step, replay insert, gradient
update]; the replay ring lives on the device. It runs on the CUDA card unless
``--device cpu`` asks for the CPU, and raises without a card otherwise.
Metrics stay on the device between log points (every 10 calls and the
last); a log line carries train_sac.py's keys and the device's name.

``--demo`` and ``--resume`` take a checkpoint of the port (train's, or this
entry point's) or a shipped policy (``artifacts/policy_sac_multi`` or the bare
name), read through ``utils/checkpoint.py``. ``--resume`` restores the actor
and both critics and copies the critics into the targets; ``--checkpoint``
saves ``actor_params`` and ``q_params`` (the modules' state dicts).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .core.env import EnvConfig, IntersectionEnv
from .device import resolve_device
from .envs.vector import VectorEnv
from .models.actor_critic import draw_noise
from .models.sac import SquashedGaussianActor, TwinQCritic
from .parallel.ppo import read_metrics
from .parallel.sac import SACConfig, SACLearner
from .utils.checkpoint import load_policy, load_sac, save_checkpoint
from .utils.profiling import StepsPerSecond


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--traffic", action="store_true")
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--npc-mode", choices=["exact", "fast"], default="exact")
    ap.add_argument("--calls", type=int, default=100,
                    help="train calls (steps_per_call env steps each)")
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=4096)
    ap.add_argument("--capacity", type=int, default=1 << 19)
    ap.add_argument("--routes", default=None,
                    help="restrict ego route sampling to a fixed pool, e.g. "
                         "'IN_6:OUT_2,IN_1:OUT_7' (default: all mapped routes)")
    ap.add_argument("--demo", default=None,
                    help="PPO checkpoint or shipped policy whose actor seeds the replay ring "
                         "with demonstration transitions before training")
    ap.add_argument("--demo-model", default="mlp", choices=["mlp", "attention", "conv", "central"],
                    help="model family of --demo (feedforward families only)")
    ap.add_argument("--demo-steps", type=int, default=200,
                    help="env steps of demonstrations (x num_envs x agents transitions)")
    ap.add_argument("--demo-noise", type=float, default=0.1,
                    help="pre-tanh gaussian exploration noise on demo actions")
    ap.add_argument("--demo-every", type=int, default=0,
                    help="every K train calls, refresh the ring with --demo-refresh demo steps")
    ap.add_argument("--demo-refresh", type=int, default=8)
    ap.add_argument("--target-entropy", type=float, default=None,
                    help="SAC entropy target (default -act_dim)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); 'cpu' to ask for it")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({dev_name})")
    env = IntersectionEnv(EnvConfig(num_agents=args.agents, traffic_flow=args.traffic,
                                    traffic_density=args.density, max_steps=2000,
                                    npc_mode=args.npc_mode), device=dev)
    route_pool = None
    if args.routes:
        route_pool = env.table.route_ids([tuple(p.split(":")) for p in args.routes.split(",")])
    venv = VectorEnv(env, num_envs=args.num_envs, route_pool=route_pool, seed=args.seed + 1)
    with torch.random.fork_rng(devices=[]):       # the networks drawn from --seed
        torch.manual_seed(args.seed)
        actor, critic = SquashedGaussianActor(), TwinQCritic()
    learner = SACLearner(venv, SACConfig(
        lr=args.lr, batch_size=args.batch_size, warmup=args.warmup,
        buffer_capacity=args.capacity, steps_per_call=args.steps_per_call,
        target_entropy=args.target_entropy), actor, critic, seed=args.seed + 2)
    ts = learner.init()
    if args.resume:
        actor, critic = load_sac(args.resume, dev)
        ts.actor.load_state_dict(actor.state_dict())
        for dst in (ts.critic, ts.critic_target):       # the targets start at the critics
            dst.load_state_dict(critic.state_dict())
        print(f"resumed actor/critic params from {args.resume}")

    state, obs = venv.reset()
    refresh = None
    if args.demo:
        _, demo_mean = load_policy(args.demo, args.demo_model, dev)

        def demo_policy(o):
            mean = demo_mean(o)
            return torch.tanh(mean + args.demo_noise * draw_noise(mean.shape, learner.generator))

        t0 = time.perf_counter()
        ts, state, obs = learner.collect(ts, state, obs, demo_policy, args.demo_steps)
        print(json.dumps({"demo_transitions": int(ts.buffer.size),
                          "secs": round(time.perf_counter() - t0, 2)}), flush=True)
        if args.demo_every:
            refresh = demo_policy

    meter = StepsPerSecond(steps_per_tick=args.num_envs * args.steps_per_call)
    t_log = time.perf_counter()
    last_log_c = -1
    for c in range(args.calls):
        if refresh is not None and c and c % args.demo_every == 0:
            ts, state, obs = learner.collect(ts, state, obs, refresh, args.demo_refresh)
        ts, state, obs, metrics = learner.train_step(ts, state, obs)
        meter.tick()
        if c % 10 == 0 or c == args.calls - 1:
            m = read_metrics(metrics)        # one copy from the device
            now = time.perf_counter()
            print(json.dumps({
                "call": c,
                "secs": round((now - t_log) / (c - last_log_c), 3),
                "env_steps_per_s": round(meter.value, 1),
                "updates": ts.update_count,
                **{k: round(v, 5) for k, v in m.items()},
                "device": dev_name}), flush=True)
            t_log, last_log_c = now, c

    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"actor_params": ts.actor.state_dict(),
                                          "q_params": ts.critic.state_dict()})
        print(f"saved {args.checkpoint}")
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


if __name__ == "__main__":
    main()
