"""The benchmark's train-step entry: a cell whose traffic file says
``"entry": "train_step"`` times the program's PPO learner
(``PPOLearner.jit_train_step()``: on the card a 64-step rollout with the
policy in the loop, GAE and the minibatch updates, replayed as CUDA graphs).
``TrainStep`` supplies run.py's shell (``run.run``) with the entry's parts:

  * set-up: the env, the inputs drawn from ``--seed`` on the card
    (portbench/traffic.py's generator: the action noise bank, the route
    bank, the episodes' phases and the checked rows; then a bank of
    minibatch permutations and the policy's parameters,
    reference/policies/<family>.py), the model of the configuration's
    ``learner`` built by the program's ``models.make_model`` with those
    parameters, the learner with ``noise_fn`` and ``perm_fn`` cycling the
    banks, the reset; then the traffic file's ``warmup_steps`` train steps
    (the first captures the graphs), whose inputs and outputs the check
    keeps on the host;
  * one window step: one call of the train step;
  * after the window, with ``--trace 1``: ``span_steps`` more calls timed by
    the learner's own ``split`` (rollout; GAE and the update);
  * the check (below) and the end-to-end values: the env transitions
    learned from (calls x rollout_len x envs) per second, the peak, the
    set-up.

How ``correct`` is decided. The set-up's train steps go through the
window's own call on the very objects the window then steps, and the
reference follows them all:

  * the env (limit 0 on each count, as check.py): the checked rows (rows
    drawn from the seed, other rows at each step, and the ``ending`` envs
    with the highest step counters, whose episodes end within the rollout)
    are stepped by the reference env from the program's state at the
    step's start, chaining its own state through the rollout's steps, with
    the program's actions (the tanh of the trajectory's sampled actions)
    and the same route draws; it compares the observation, reward, done
    flags and status at every step, and the state at the end, bit for bit.
    The reset, the chain's start, is checked by itself. The reference env
    is too slow for the whole batch: the other rows of the trajectory
    (16,356 of 16,384 a step at 4096 x 4), which the learner's reference
    reads as the env's data, are taken on trust from the program;
  * GAE (limit 0): the reference's GAE of the program's trajectory, values
    and last value against the program's advantages and returns;
  * the rollout's policy (reference/ppo.py): at the parameters the program
    entered each step with, on the step's observations and noise, the
    sampled actions, values (the last value included) and log-probabilities
    at the trajectory's actions (relative L2 error, the largest over the
    steps);
  * the update (reference/ppo.py): the reference learner takes each step
    from the program's state entering it (its parameters and Adam's state;
    the first step from the drawn parameters and a fresh Adam, as the
    program's), on the step's trajectory, noise and permutations. PPO's
    loss is piecewise (the ratio's clip, the value's clip, the global-norm
    clip), so rounding moves samples across its branches, and a reference
    that chained its own state drifted from the program's by up to 5% of a
    leaf's change over three steps (PERF.md). Compared: each step's loss
    (the mean over its minibatches), its gap over the loss's scale (the
    mean of the sum of its terms' magnitudes: the entropy bonus and the
    value loss nearly cancel at the first steps); the gradient as Adam took
    it over the first step (its first moments, ``grad``); the parameters'
    change over the steps, the reference's being the sum of its steps'
    changes (``change``); and the hand-over of Adam's state between steps:
    the program's first and second moments after each step against the
    reference's after that step (``moments``, the worst of both), and its
    steps taken, exactly (``adam_steps``, the steps where they differ).
    The leaf numbers by the worst leaf: the gap between the program's norm
    and the reference's, over the reference's norm of that leaf or of the
    median leaf, whichever is larger; a leaf whose reference gradient lies
    under a thousandth of the median leaf's is left out of ``change`` and
    ``moments``.

The program's trajectory, last value, advantages and returns of a step are
the graphed step's static buffers (``traj``, ``last_value``, ``advs``,
``rets``): the program has no public accessor for them yet (PERF.md,
section 7). An eager step (the CPU) keeps none, so there the harness keeps
what the learner's ``_gae`` is called with and returns.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from marl_traffic_intersection_tpu_torch.core.env import EnvConfig, IntersectionEnv
from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner

from . import check, roofline, traffic, window
from .reference import ppo as ref_ppo
from .reference import vector as ref_vector

_KEYS = {"entry", "density", "crowd", "warmup_steps", "banks", "stagger_episodes", "check",
         "profile_steps", "span_steps", "why"}
# the numbers compared and their limits (PERF.md gives the readings they were set from):
# counts of values whose bits differ, and the rollout's relative errors, which read 0
ENV_LIMITS = {"start": 0, "ego": 0, "lidar": 0, "obs": 0, "reward": 0, "status": 0}
LIMITS = {**ENV_LIMITS, "gae": 0, "raw": 0, "value": 0, "logp": 0, "loss": 2e-3, "grad": 0.05,
          "change": 4e-3, "moments": 0.2, "adam_steps": 0}
LEAF_FLOOR = 1e-3           # a leaf's gradient under this share of the median leaf's: not counted
# the env's outputs compared at each rollout step, and the count each goes to
_GROUPS = (("obs", "obs"), ("reward", "reward"), ("ep_done", "status"), ("done", "status"),
           ("status", "status"))


def validate(traffic: dict) -> dict:
    unknown, missing = set(traffic) - _KEYS, _KEYS - {"why"} - set(traffic)
    if unknown or missing:
        raise ValueError(f"traffic file: unknown keys {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    if traffic["density"] is not None or traffic["crowd"] is not None:
        raise ValueError("the train-step entry runs without NPC traffic")
    return traffic


def env_traffic(tr: dict) -> dict:
    """The traffic generator's parameters of a train-step mix: its noise bank
    is the generator's action bank, and the checked rows are drawn for every
    warm-up step at once."""
    calls = tr["warmup_steps"]
    return {"density": None, "crowd": None, "warmup_steps": calls,
            "banks": {"actions": tr["banks"]["noise"], "routes": tr["banks"]["routes"]},
            "stagger_episodes": tr["stagger_episodes"],
            "check": {"steps": calls, "horizon": calls, "envs": calls * tr["check"]["envs"]},
            "profile_steps": tr["profile_steps"]}


class Bank:
    """A draw that cycles ``bank``: call i returns entry i % len(bank), of
    the shape asked for; ``pos`` counts the calls."""

    def __init__(self, bank: torch.Tensor):
        self.bank, self.pos = bank, 0

    def __call__(self, shape):
        out = self.bank[self.pos % self.bank.shape[0]]
        want = tuple(shape) if isinstance(shape, (tuple, list, torch.Size)) else (shape,)
        if tuple(out.shape) != want:
            raise ValueError(f"the bank's entries are {tuple(out.shape)}, asked for {want}")
        self.pos += 1
        return out

    def entries(self, start: int, n: int) -> torch.Tensor:
        return torch.stack([self.bank[(start + i) % self.bank.shape[0]] for i in range(n)])


class Taps:
    """The last train step's (trajectory, last value, advantages, returns):
    the graphed step's static buffers on the card, or on the CPU, where the
    step is the eager ``train_step``, what the learner's ``_gae`` was last
    called with and returned."""

    def __init__(self, learner, step, on_card: bool):
        self.step, self.kept = step, None
        if not on_card:
            gae = learner._gae

            def kept(traj, last_value):
                advs, rets = gae(traj, last_value)
                self.kept = (traj, last_value, advs, rets)
                return advs, rets
            learner._gae = kept

    def last(self) -> tuple:
        if self.kept is not None:
            return self.kept
        s = self.step
        return s.traj, s.last_value, s.advs, s.rets


def hyper(cfg: dict):
    """The reference's hyperparameters of a configuration's ``learner``."""
    ppo, adam = cfg["ppo"], cfg["adam"]
    if ppo.get("critic_warmup", 0):
        raise ValueError("the reference learner has no critic warm-up")
    return ref_ppo.Hyper(**{k: ppo[k] for k in (
        "rollout_len", "update_epochs", "num_minibatches", "gamma", "gae_lambda", "clip_eps",
        "vf_coef", "ent_coef", "lr", "max_grad_norm")},
        adam_betas=tuple(adam["betas"]), adam_eps=adam["eps"])


def adam_state(optimizer, named: dict) -> tuple:
    """Adam's (first moments, second moments, steps taken) of the parameters
    ``named``, float32 copies on the host (zeros before its first step);
    the steps taken are the sorted distinct counts of the parameters ([0]
    before the first step)."""
    moments, steps = [{}, {}], set()
    for name, p in named.items():
        st = optimizer.state.get(p, {})
        for out, key in zip(moments, ("exp_avg", "exp_avg_sq")):
            out[name] = st.get(key, torch.zeros_like(p)).float().to("cpu", copy=True)
        steps.add(int(float(st["step"])) if "step" in st else 0)
    return (*moments, sorted(steps))


def _host(tree):
    return check.tree_map(lambda t: t.to("cpu", copy=True), tree)


class TrainStep:
    """The train step's entry (see the module docstring)."""

    LIMITS = LIMITS

    def __init__(self, cell, seed: int, dev, split):
        self.dev = dev
        self.on_card = on_card = dev.type == "cuda"
        self.tr = tr = validate(cell.traffic)
        self.lcfg = lcfg = cell.config["learner"]
        if lcfg["algorithm"] != "ppo":
            raise ValueError(f"no train step for the algorithm {lcfg['algorithm']!r}")
        self.h = h = hyper(lcfg)
        self.env_cfg = env_cfg = cell.env_config()
        B = cell.num_envs
        env = IntersectionEnv(EnvConfig(**env_cfg), device=dev)
        N = env.config.num_agents
        self.rows_per_step = B * h.rollout_len          # env transitions a call
        split("env_build_s")

        self.ref = ref = check.reference_env(env_cfg)
        self.inputs = inputs = traffic.make_inputs(
            env_traffic(tr), B, N, env.config.max_steps, ref_vector.route_pool(ref),
            int(ref.traffic_ids.shape[0]), seed, dev)
        g = torch.Generator(device=dev).manual_seed((traffic.seed64(seed) + 1) % (1 << 64))
        perms = torch.argsort(torch.rand((tr["banks"]["perms"], h.rollout_len), generator=g,
                                         device=dev), dim=-1)
        policy = ref_ppo.policy(lcfg["model"])
        params0 = policy.init(lcfg["widths"], g, dev)
        self.noise, self.perm = Bank(inputs.actions), Bank(perms)
        model = make_model(lcfg["model"], **lcfg["widths"],
                           compute_dtype=ref_ppo.DTYPES[lcfg["compute_dtype"]])
        forward = policy.flops_per_sample(lcfg["widths"])
        self.step_flops = roofline.train_step_flops(forward, B * N, h.rollout_len,
                                                    h.update_epochs)
        self.update_flops = roofline.update_flops(forward, B * N, h.rollout_len,
                                                  h.update_epochs)
        self.peak_flops = roofline.PEAK_FLOPS_PER_S[lcfg["compute_dtype"]]
        split("inputs_s")

        venv = VectorEnv(env, B, route_sampler=inputs.routes)
        lrn = PPOLearner(venv, model, PPOConfig(**lcfg["ppo"]), noise_fn=self.noise,
                         perm_fn=self.perm)
        ts = lrn.init()
        named = dict(ts.model.named_parameters())
        if {k: tuple(p.shape) for k, p in named.items()} != \
                {k: tuple(p.shape) for k, p in params0.items()}:
            raise ValueError("the program's parameters are not the configuration's")
        group = ts.optimizer.param_groups[0]
        if (group["lr"], tuple(group["betas"]), group["eps"]) != (h.lr, h.adam_betas,
                                                                   h.adam_eps):
            raise ValueError(f"the program's Adam {group} departs from the configuration")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params0[k])
        self.step = lrn.jit_train_step()
        taps = Taps(lrn, self.step, on_card)
        state, obs = venv.reset()
        drawn = torch.as_tensor(inputs.check_rows, dtype=torch.long, device=dev)
        self.start = (check.take_rows(state, drawn), obs.index_select(0, drawn),
                      inputs.routes.entry(inputs.routes.last).index_select(0, drawn).to("cpu"))
        if inputs.step_count is not None:
            state = state._replace(step_count=inputs.step_count.clone())
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        split("reset_s")

        calls, ending = tr["warmup_steps"], tr["check"]["ending"]
        self.recs, call_s = [], []
        for k in range(calls):
            rows = torch.cat([drawn[k::calls], state.step_count.topk(min(ending, B)).indices])
            rec = {"rows": rows.to("cpu"), "state_in": _host(check.take_rows(state, rows)),
                   "route_pos": inputs.routes.calls, "noise_pos": self.noise.pos,
                   "perm_pos": self.perm.pos,
                   "params_in": {name: p.detach().float().to("cpu", copy=True)
                                 for name, p in named.items()},
                   "adam_in": adam_state(ts.optimizer, named)}
            sync()
            t0 = time.perf_counter()
            ts, state, obs, metrics = self.step(ts, state, obs)
            sync()
            call_s.append(time.perf_counter() - t0)
            traj, last_value, advs, rets = taps.last()
            rec.update(traj=_host(traj), last_value=_host(last_value), advs=_host(advs),
                       rets=_host(rets), obs_out=_host(obs),
                       state_out=_host(check.take_rows(state, rows)),
                       actions=_host(torch.tanh(traj.raw_action.index_select(1, rows))),
                       metrics={name: float(v) for name, v in metrics.items()},
                       adam_out=adam_state(ts.optimizer, named))
            self.recs.append(rec)
        self.params_after = {name: p.detach().float().to("cpu", copy=True)
                             for name, p in named.items()}
        self.params0 = {k: v.to("cpu") for k, v in params0.items()}
        self.ts, self.state, self.obs = ts, state, obs
        # the poses that the window's first rollout step scans (run.py's lidar reading)
        self.poses, self.pose_width = check.poses(state), None
        sync()
        split.t["warmup_call_s"] = call_s
        self.warm_rate = 1.0 / max(min(call_s[1:] or call_s), 1e-9)
        self.profile_steps = tr["profile_steps"]
        self.splits = []

    def one(self, k=None) -> None:
        """One call of the train step."""
        self.ts, self.state, self.obs, _ = self.step(self.ts, self.state, self.obs)

    def opened(self) -> None:
        pass

    def closed(self, steps: int, trace: bool) -> None:
        """After the window, with a trace: ``span_steps`` calls timed by the
        learner's ``split``."""
        for _ in range(self.tr["span_steps"] if trace else 0):
            self.splits.append({})
            self.ts, self.state, self.obs, _ = self.step(self.ts, self.state, self.obs,
                                                         self.splits[-1])

    def free(self) -> None:
        del self.step, self.ts, self.state, self.obs, self.poses

    def check(self) -> tuple:
        self.ck = ck = types.SimpleNamespace(
            ref=self.ref, recs=self.recs, start=self.start, inputs=self.inputs,
            noise=self.noise, perm=self.perm, params0=self.params0,
            params_after=self.params_after, lcfg=self.lcfg, hyper=self.h, device=self.dev)
        readings = check_env(ck)
        readings.update(check_learner(ck))
        return readings, all(readings[k] <= lim for k, lim in LIMITS.items())

    def reader_fields(self, profile) -> dict:
        """The learner's readings for the per-layer readers: its spans, the
        update's and a call's model FLOPs, the peak; the profile's ``steps``
        counted in env steps (a call is ``rollout_len`` of them), so that
        the per-step readers read per env step as in the env cells."""
        if profile is None:
            return {"splits": self.splits, "update_flops": self.update_flops,
                    "peak_flops": self.peak_flops}
        return {"splits": self.splits, "update_flops": self.update_flops,
                "peak_flops": self.peak_flops,
                "profiled_flops": self.step_flops * profile["steps"],
                "profile": dict(profile, steps=profile["steps"] * self.h.rollout_len)}

    def end_to_end(self, win, peak: int, setup_s: float) -> dict:
        return {"env_steps_per_s": window.env_steps_per_s(win, self.rows_per_step),
                "peak_mem_mib": peak / 2 ** 20, "setup_s": setup_s}

    def window_notes(self) -> dict:
        return {"env_steps_per_call": self.h.rollout_len}

    def check_notes(self) -> dict:
        return {"calls": len(self.recs), "rows_per_call": [len(r["rows"]) for r in self.recs],
                "losses": [r["metrics"] for r in self.recs]}

    def trace_notes(self) -> dict:
        return {"splits": self.splits}

    def checked(self):
        return self.ck


def check_env(ck) -> dict:
    """The env's counts (ENV_LIMITS' keys) over the warm-up's steps, and
    ``failed_env_steps``, the checked env transitions that differ anywhere,
    and ``episode_ends``, the checked envs whose episode ended."""
    total = dict.fromkeys(ENV_LIMITS, 0)
    prog_state, prog_obs, routes0 = ck.start
    ref_state = ck.ref.reset_state(routes0)
    total["start"] = check.mismatches(check.as_reference(prog_state), ref_state) \
        + check.mismatches(prog_obs.to("cpu"), ck.ref.observe(ref_state))
    failed = ends = 0
    for rec in ck.recs:
        rows, traj = rec["rows"], rec["traj"]
        obs = traj.obs.index_select(1, rows)
        want = {"reward": traj.reward.index_select(1, rows),
                "ep_done": traj.ep_done.index_select(1, rows),
                "done": traj.agent_done.index_select(1, rows),
                "status": traj.status.index_select(1, rows)}
        state = check.as_reference(rec["state_in"])
        T = obs.shape[0]
        for s in range(T):
            routes = ck.inputs.routes.entry(rec["route_pos"] + s).index_select(
                0, rows.to(ck.inputs.routes.bank.device)).to("cpu")
            state, out = ref_vector.step(ck.ref, state, rec["actions"][s], None, routes)
            got = {"obs": obs[s + 1] if s + 1 < T else rec["obs_out"].index_select(0, rows),
                   **{k: v[s] for k, v in want.items()}}
            mine = {"obs": out.obs, "reward": out.reward,
                    "ep_done": out.terminated | out.truncated, "done": out.done,
                    "status": out.status}
            for name, group in _GROUPS:
                total[group] += check.mismatches(got[name], mine[name])
            failed += check.failed_rows(None, got, None, mine)
            ends += int(mine["ep_done"].sum())
        end = check.as_reference(rec["state_out"])
        total["ego"] += check.mismatches(end.ego, state.ego)
        total["lidar"] += check.mismatches(end.lidar, state.lidar)
        total["status"] += check.mismatches(end.step_count, state.step_count)
    return {**total, "failed_env_steps": failed, "episode_ends": ends}


def _learner(ck, params: dict, variant=None, adam=None):
    """A reference learner (reference/ppo.py) from ``params`` (and Adam's
    state ``adam``), on the card where the run ran."""
    ref_ppo.no_tf32()
    dev = ck.device
    if adam is not None:
        m, v, steps = adam          # parameters that took different steps: the most
        adam = ({k: x.to(dev) for k, x in m.items()}, {k: x.to(dev) for k, x in v.items()},
                max(steps))
    return ref_ppo.Learner(ck.lcfg["model"], ck.lcfg["widths"],
                           {k: x.to(dev) for k, x in params.items()}, ck.hyper,
                           ck.lcfg["compute_dtype"], variant, adam)


def _step_data(ck, rec) -> tuple:
    """A checked step's trajectory, noise and permutations on the card."""
    h, dev, traj = ck.hyper, ck.device, rec["traj"]
    data = {"obs": traj.obs.to(dev), "raw": traj.raw_action.to(dev),
            "reward": traj.reward.to(dev), "ep_done": traj.ep_done.to(dev),
            "agent_done": traj.agent_done.to(dev), "last_obs": rec["obs_out"].to(dev)}
    noise = ck.noise.entries(rec["noise_pos"], h.rollout_len).to(dev)
    perms = [ck.perm.bank[(rec["perm_pos"] + e) % ck.perm.bank.shape[0]].to(dev)
             for e in range(h.update_epochs)]
    return data, noise, perms


def program_acts(ck) -> list:
    """The program's rollout outputs of each checked step: sampled actions,
    values, log-probabilities, last value."""
    return [{"raw": rec["traj"].raw_action, "value": rec["traj"].value,
             "logp": rec["traj"].logp, "last_value": rec["last_value"]} for rec in ck.recs]


def acts(ck, variant=None) -> list:
    """The reference's (or a variant's) rollout outputs of each checked step,
    at the parameters the program entered the step with, on the step's
    observations, noise and sampled actions."""
    out = []
    for rec in ck.recs:
        data, noise, _ = _step_data(ck, rec)
        got = _learner(ck, rec["params_in"], variant).act(data["obs"], data["raw"],
                                                          data["last_obs"], noise)
        out.append(dict(zip(("raw", "value", "logp", "last_value"),
                            (t.to("cpu") for t in got))))
        del data
    return out


def program_chain(ck) -> dict:
    """What the program's checked steps gave of their update: each step's
    mean loss over its minibatches (from its metrics), Adam's first moments
    after the first step, the parameters' change over the steps, and Adam's
    state after each step."""
    h = ck.hyper
    return {"losses": [m["pg_loss"] - h.ent_coef * m["entropy"] + h.vf_coef * m["v_loss"]
                       for m in (rec["metrics"] for rec in ck.recs)],
            "m1": ck.recs[0]["adam_out"][0],
            "change": {k: v - ck.params0[k] for k, v in ck.params_after.items()},
            "adam": [rec["adam_out"] for rec in ck.recs]}


def follow(ck, variant=None) -> dict:
    """The reference learner (or a variant in the program's place) through
    each checked step from the program's state entering it (its parameters
    and Adam's state), as ``program_chain``: the change is the sum of the
    steps' changes."""
    losses, scales, adam, change = [], [], [], None
    for rec in ck.recs:
        data, noise, perms = _step_data(ck, rec)
        lrn = _learner(ck, rec["params_in"], variant, rec["adam_in"])
        out = lrn.step(data, noise, perms)
        losses.append(out["loss"])
        scales.append(out["scale"])
        params, (m, v, t) = lrn.result()
        adam.append(({k: x.to("cpu") for k, x in m.items()},
                     {k: x.to("cpu") for k, x in v.items()}, [t]))
        step = {k: params[k].to("cpu") - rec["params_in"][k] for k in params}
        change = step if change is None else {k: change[k] + step[k] for k in step}
        del data, lrn
    return {"losses": losses, "scales": scales, "m1": adam[0][0], "change": change,
            "adam": adam}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a - b‖ / ‖b‖ (float64)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gap between norms (see the module docstring)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - n) / max(n, median, 1e-300)
            for k, n in norms.items()}


def act_numbers(got: list, want: list) -> dict:
    """The rollout's numbers: each the largest relative L2 error over the steps."""
    out = {"raw": 0.0, "value": 0.0, "logp": 0.0}
    for g, w in zip(got, want):
        out["raw"] = max(out["raw"], _rel(g["raw"], w["raw"]))
        out["value"] = max(out["value"], _rel(
            torch.cat([g["value"].reshape(-1), g["last_value"].reshape(-1)]),
            torch.cat([w["value"].reshape(-1), w["last_value"].reshape(-1)])))
        out["logp"] = max(out["logp"], _rel(g["logp"], w["logp"]))
    return out


def chain_numbers(got: dict, want: dict) -> dict:
    """The update's numbers of ``got`` (the program's chain, or a variant's)
    against ``want`` (the reference's); each leaf's gaps beside."""
    losses = [abs(g - w) / max(scale, 1e-30)
              for g, w, scale in zip(got["losses"], want["losses"], want["scales"])]
    grad_norm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want["m1"].items()}
    floor = LEAF_FLOOR * float(np.median(list(grad_norm.values())))
    counted = [k for k, v in grad_norm.items() if v >= floor]

    def leaves(tree):
        return {k: tree[k].float() for k in counted}
    grad = _leaf_gaps(got["m1"], want["m1"])
    change = _leaf_gaps(leaves(got["change"]), leaves(want["change"]))
    moments = [max(max(_leaf_gaps(leaves(g[i]), leaves(w[i])).values()) for i in (0, 1))
               for g, w in zip(got["adam"], want["adam"])]
    return {"loss": max(losses), "grad": max(grad.values()), "change": max(change.values()),
            "moments": max(moments),
            "adam_steps": sum(g[2] != w[2] for g, w in zip(got["adam"], want["adam"])),
            "loss_steps": losses, "grad_leaves": grad, "change_leaves": change,
            "moments_steps": moments, "leaves_left_out": sorted(set(grad_norm) - set(counted))}


def check_learner(ck) -> dict:
    """GAE's count and the learner's numbers of the program's checked steps."""
    h, bad, dev = ck.hyper, 0, ck.device
    for rec in ck.recs:
        traj = rec["traj"]
        advs, rets = ref_ppo.gae(traj.reward.to(dev), traj.value.to(dev), traj.ep_done.to(dev),
                                 traj.agent_done.to(dev), rec["last_value"].to(dev), h.gamma,
                                 h.gae_lambda)
        bad += check.mismatches((rec["advs"], rec["rets"]), (advs.to("cpu"), rets.to("cpu")))
    return {"gae": bad, **act_numbers(program_acts(ck), acts(ck)),
            **chain_numbers(program_chain(ck), follow(ck))}
