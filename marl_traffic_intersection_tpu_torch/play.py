"""Manual-control / scripted demo harness: the port's counterpart of play.py
(itself the analogue of the reference test.py).

The reference harness drives a GLFW window with arrow keys and a real-time
fixed-substep loop (reference: test.py:100-172). This version supports:

  - interactive matplotlib keyboard driving when a display is available
    (arrows = throttle/steer, r = reset, l = toggle lidar, o = obs dump,
    q = quit)
  - headless scripted mode (--script) that drives eval.py's Stanley baseline
    (or a trained policy of any family, --checkpoint/--model) and writes an
    animated GIF of every third frame to --out

Both use the same real-time substepping: elapsed wall time is consumed in
dt = min(remaining, 1/60) chunks per frame (test.py:144-156).

  python -m marl_traffic_intersection_tpu_torch.play --script --steps 120 --traffic --density 8
  python -m marl_traffic_intersection_tpu_torch.play --script --checkpoint policy_gru_cfg1 --model gru

It runs on the card unless ``--device cpu`` asks for the CPU (play.py runs
on the host by default). PIL and matplotlib are needed only for the frames
and the window.
"""
from __future__ import annotations

import argparse
import os
import random
import tempfile
import time

import numpy as np
import torch

from .core.routes import DEFAULT_ROUTE_MAPPING_2LANES, DEFAULT_ROUTE_MAPPING_3LANES
from .envs.gym import GymIntersectionEnv
from .evaluate import scripted_policy
from .models import MODEL_FAMILIES
from .utils.checkpoint import load_policy


def all_routes(num_lanes: int):
    mapping = DEFAULT_ROUTE_MAPPING_2LANES if num_lanes == 2 else DEFAULT_ROUTE_MAPPING_3LANES
    return [(s, e) for s, ends in mapping.items() for e in ends]


def make_checkpoint_policy(checkpoint: str, model_kind: str, device):
    """Deterministic-mean driver from a trained policy of any family: numpy
    (N, 127) observations in, numpy (N, 2) actions out; the GRU carries its
    hidden state from call to call."""
    model, mean_fn = load_policy(checkpoint, model_kind, device)
    carry = {"h": None}

    def policy(obs2):
        obs = torch.from_numpy(np.ascontiguousarray(obs2, np.float32)).to(device)
        if model_kind == "gru":
            if carry["h"] is None:
                carry["h"] = model.initial_hidden(obs.shape[0], device=device)
            mean, carry["h"] = mean_fn(obs, carry["h"])
        else:
            mean = mean_fn(obs)
        return torch.tanh(mean).cpu().numpy()

    return policy


def scripted(env: GymIntersectionEnv, steps: int, out: str, policy=None):
    """Drive with the Stanley baseline controller (evaluate.scripted_policy)
    or a trained policy; write a GIF of every third frame."""
    from PIL import Image

    frames = []
    obs, _ = env.reset()
    total = 0.0
    for t in range(steps):
        obs2 = obs if obs.ndim == 2 else obs[None]
        if policy is None:
            acts = scripted_policy(obs2, env._host_view(), env._core.table)
        else:
            acts = policy(obs2)
        r = env.step(acts if env.num_agents > 1 and not env.traffic_flow else acts[0])
        obs, rew, term, trunc, info = r
        total += float(np.sum(rew))
        if t % 3 == 0:
            frames.append(Image.fromarray(env.render()))
        if term or trunc:
            obs, _ = env.reset()
    if frames:
        frames[0].save(out, save_all=True, append_images=frames[1:], duration=50, loop=0)
        print(f"wrote {out} ({len(frames)} frames), total reward {total:.2f}")
    return frames


def print_obs_snapshot(obs, intent: int = None):
    """Obs stats dump, the 'O' key behavior of the reference harness
    (reference: test.py:87-98)."""
    if obs is None:
        print("Obs not yet available.")
        return
    flat = np.asarray(obs).flatten()
    print(f"Obs shape: {flat.shape}, min: {flat.min():.4f}, "
          f"max: {flat.max():.4f}, mean: {flat.mean():.4f}")
    n = min(20, flat.size)
    preview = np.array2string(flat[:n], precision=3, separator=", ")
    print(f"Obs preview (first {n}): {preview}" + (" ..." if flat.size > n else ""))
    if intent is not None:
        labels = {0: "STRAIGHT", 1: "LEFT", 2: "RIGHT"}
        print(f"Ego intention: {labels.get(int(intent), f'UNKNOWN({intent})')}")


def _intent(env: GymIntersectionEnv) -> int:
    rid = int(env._host_view().ego.route_id[0])
    return int(env._core.table.intent[rid])


def interactive(env: GymIntersectionEnv):
    import matplotlib.pyplot as plt

    pressed = set()
    state = {"show_lidar": True, "quit": False, "print_obs": False, "obs": None}

    def on_key(event, down: bool):
        k = event.key
        if down and k == "q":
            state["quit"] = True
        elif down and k == "r":
            env.ego_routes = [random.choice(all_routes(env.num_lanes))]
            env.reset()
        elif down and k == "l":
            state["show_lidar"] = not state["show_lidar"]
        elif down and k == "o":
            # 'O' toggles obs-stats logging (reference: test.py:128-134)
            state["print_obs"] = not state["print_obs"]
            print(f"Observation logging "
                  f"{'ENABLED' if state['print_obs'] else 'DISABLED'}.")
            if state["print_obs"]:
                print_obs_snapshot(state["obs"], intent=_intent(env))
        elif k in ("up", "down", "left", "right"):
            (pressed.add if down else pressed.discard)(k)

    fig, ax = plt.subplots(figsize=(7, 7))
    fig.canvas.mpl_connect("key_press_event", lambda e: on_key(e, True))
    fig.canvas.mpl_connect("key_release_event", lambda e: on_key(e, False))
    # also feed the reference-parity event surface (env.env.key_pressed /
    # poll_events / window_should_close, envs/events.py)
    env.env.attach_matplotlib(fig)
    obs, _ = env.reset()
    im = ax.imshow(env.render(show_lidar=state["show_lidar"]))
    plt.ion()
    plt.show()

    last = time.perf_counter()
    while not state["quit"] and plt.fignum_exists(fig.number):
        throttle = (1.0 if "up" in pressed else 0.0) + (-1.0 if "down" in pressed else 0.0)
        steer = (1.0 if "left" in pressed else 0.0) + (-1.0 if "right" in pressed else 0.0)
        now = time.perf_counter()
        remaining = min(now - last, 0.25)
        last = now
        while remaining > 1e-9:  # fixed-substep integration (test.py:144-156)
            dt = min(remaining, 1.0 / 60.0)
            obs, rew, term, trunc, info = env.step(
                np.array([throttle, steer], np.float32), dt=dt)
            remaining -= dt
        state["obs"] = obs
        if state["print_obs"]:  # per-frame dump while enabled (test.py:159-161)
            print_obs_snapshot(obs, intent=_intent(env))
        im.set_data(env.render(show_lidar=state["show_lidar"]))
        fig.canvas.draw_idle()
        plt.pause(1.0 / 60.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--script", action="store_true", help="headless scripted demo")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mti_demo.gif"))
    ap.add_argument("--traffic", action="store_true")
    ap.add_argument("--density", type=float, default=10.0)
    ap.add_argument("--agents", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=3)
    ap.add_argument("--checkpoint", default=None,
                    help="drive with a trained policy instead of the Stanley baseline "
                         "(scripted mode only): a checkpoint of the port or a shipped policy")
    ap.add_argument("--model", choices=sorted(MODEL_FAMILIES), default="mlp",
                    help="model family of --checkpoint")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to ask for the CPU")
    args = ap.parse_args(argv)

    env = GymIntersectionEnv({
        "traffic_flow": args.traffic,
        "traffic_density": args.density,
        "num_agents": args.agents,
        "num_lanes": args.lanes,
        "render_mode": "rgb_array" if args.script else "human",
        "max_steps": 100000,
        "respawn_enabled": True,
        "show_lidar": True,
        "device": args.device,
    })
    env.ego_routes = [random.choice(all_routes(args.lanes)) for _ in range(env.num_agents)]
    env.reset()
    if args.script:
        policy = (make_checkpoint_policy(args.checkpoint, args.model, env.device)
                  if args.checkpoint else None)
        scripted(env, args.steps, args.out, policy=policy)
    else:
        interactive(env)


if __name__ == "__main__":
    main()
