"""PPO learner over the batched env: rollout, GAE and the clipped-PPO update.

Counterpart of marl_traffic_intersection_tpu/parallel/ppo.py, run eagerly on
one device. One ``train_step`` is a rollout of ``rollout_len`` env steps with
the policy in the loop (the env step launches kernel K1 and the libm
kernels), GAE backwards over the trajectory, then ``update_epochs`` epochs of
``num_minibatches`` clipped-PPO minibatches. Every agent is an independent
decision-maker under one shared policy; per-agent rewards come from the env.

Where a straight transcription of the JAX code goes wrong, this one follows
the JAX package:

  - minibatches slice the time axis after one permutation per epoch; the
    permutation comes from ``perm_fn`` (default ``torch.randperm`` on the
    learner's generator), the action noise from ``noise_fn`` (default a
    normal draw on another generator), so tests can replay jax.random draws;
  - advantages are normalized with the population std (numpy's ddof = 0);
  - the gradient clip is optax's ``clip_by_global_norm``: gradients pass
    unchanged when the global norm is below ``max_grad_norm`` and become
    ``(g / norm) * max_grad_norm`` otherwise, decided on the device;
  - the optimizer is ``torch.optim.Adam(lr, eps=1e-8)``, optax's ``adam``;
  - ``update_count`` ticks per minibatch and is a host integer, so the
    critic-warmup gate costs no device sync;
  - GAE rounds each operation on its own, in float32;
  - metrics stay on the device, averaged over the minibatches, until the
    caller reads them.

The trajectory buffers are allocated once per rollout at their full (T, ...)
size and filled in place.

``jit_train_step()`` is the JAX package's ``jit_train_step()`` without a
mesh: on the card the rollout step, GAE and each minibatch update replay
CUDA graphs (utils/graphs.py, ``_GraphedTrainStep``), the draws made
eagerly as here; on the CPU it is ``train_step``.

``distributed(mesh, model_kind)`` runs the same step on a ``(data, model)``
mesh (parallel/mesh.py), one process per rank, and returns ``(step,
shard_ts, shard_env)`` as the JAX package's ``jit_train_step(mesh)`` does.
The step equals the single-process step on the global batch up to the order
of float32 sums:

  - the env and the action noise draw for the global batch and keep the
    rank's rows (envs/vector.py), and every rank draws the same minibatch
    permutations of the time axis, so each cuts the same time slices from
    its env shard;
  - advantages are normalised with the global minibatch's mean and
    population std: two all-reduced sums, two passes as in one process;
  - the gradients are averaged over the data ranks, then clipped by the
    global norm, whose split parameters' squares are summed over the model
    ranks and whose replicated ones count once; Adam on a shard equals Adam
    on the whole, elementwise;
  - metrics stay per rank until ``read_metrics(metrics, mesh)`` averages
    them over the data ranks, one all-reduce per log point.

No collective runs over an axis of one rank (parallel/mesh.py), so at one
data rank the advantage statistics, the gradients and the metrics take the
single-process path, as XLA drops a psum over a size-1 axis.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..core.constants import (STATUS_CRASH_CAR, STATUS_CRASH_LINE, STATUS_CRASH_WALL,
                              STATUS_SUCCESS)
from ..models.actor_critic import draw_noise, logp_and_entropy, sample_action
from ..utils.graphs import Graph, GraphPool, Segments, capturable_, copy_tree_, leaves, stage
from .mesh import (average_gradients_, axis_mean, axis_sum_, data_axis, global_grad_norm,
                   global_rows, model_axis, shard_batch_tree, shard_model_)

LOSS_METRICS = ("pg_loss", "v_loss", "entropy", "approx_kl")
TRAJ_METRICS = ("mean_reward", "mean_value", "success_rate", "crash_rate")


@dataclass(frozen=True)
class PPOConfig:
    rollout_len: int = 128
    update_epochs: int = 4
    num_minibatches: int = 4   # minibatches slice the time axis
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    critic_warmup: int = 0     # train steps with the actor loss masked


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    update_count: int = 0      # minibatch updates so far


class Transition(NamedTuple):
    obs: torch.Tensor          # (T, B, N, 127)
    raw_action: torch.Tensor   # (T, B, N, 2) pre-tanh
    logp: torch.Tensor         # (T, B, N)
    value: torch.Tensor        # (T, B, N)
    reward: torch.Tensor       # (T, B, N)
    ep_done: torch.Tensor      # (T, B) episode boundary (terminated | truncated)
    agent_done: torch.Tensor   # (T, B, N) per-agent done (crash -> respawn, success)
    status: torch.Tensor       # (T, B, N) int32 STATUS_*


def trajectory_metrics(traj) -> Dict[str, torch.Tensor]:
    """The rollout's metrics of ``TRAJ_METRICS``, 0-d tensors on the device."""
    st = traj.status
    crash = (st == STATUS_CRASH_CAR) | (st == STATUS_CRASH_WALL) | (st == STATUS_CRASH_LINE)
    return dict(mean_reward=traj.reward.mean(), mean_value=traj.value.mean(),
                success_rate=(st == STATUS_SUCCESS).float().mean(),
                crash_rate=crash.float().mean())


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm on ``grads`` in place; returns the norm
    (given, or that of ``grads``)."""
    if norm is None:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class PPOLearner:
    def __init__(self, vec_env, model: nn.Module, cfg: PPOConfig = PPOConfig(), seed: int = 0,
                 noise_fn: Optional[Callable[[torch.Size], torch.Tensor]] = None,
                 perm_fn: Optional[Callable[[int], torch.Tensor]] = None):
        self.env = vec_env
        self.model = model
        self.cfg = cfg
        self.device = vec_env.env.device
        self.noise_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.perm_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.noise_fn = noise_fn or (lambda shape: draw_noise(shape, self.noise_generator))
        self.perm_fn = perm_fn or (lambda n: torch.randperm(
            n, generator=self.perm_generator, device=self.device))
        self.mesh = None

    def distributed(self, mesh, model_kind: str):
        """Bind the learner to ``mesh``: ``(step, shard_ts, shard_env)``.
        ``step`` is ``train_step``; ``shard_ts(ts)`` splits the model (and
        Adam's moments) over the model axis by ``model_kind``'s rules;
        ``shard_env(*carry)`` cuts a global carry (env state, obs [, hidden
        state]) to this rank's envs. See the module docstring."""
        if self.mesh is None:
            self.mesh, self.data_axis, self.model_axis = mesh, data_axis(mesh), model_axis(mesh)
            self.env = self.env.with_mesh(mesh)
            draw = self.noise_fn
            self.noise_fn = lambda shape: global_rows(self.data_axis, draw, shape)
        elif self.mesh is not mesh:
            raise ValueError("the learner is bound to another mesh")

        def shard_ts(ts: TrainState) -> TrainState:
            shard_model_(ts.model, model_kind, mesh, [ts.optimizer])
            return ts

        def shard_env(*carry):
            return shard_batch_tree(mesh, carry)

        return self.train_step, shard_ts, shard_env

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init(self) -> TrainState:
        """The model on the env's device and a fresh Adam over its parameters."""
        model = self.model.to(self.device)
        return TrainState(model, torch.optim.Adam(model.parameters(), lr=self.cfg.lr, eps=1e-8))

    # ------------------------------------------------------------------ rollout
    @torch.no_grad()
    def _rollout(self, model: nn.Module, env_state, obs: torch.Tensor):
        T = self.cfg.rollout_len
        b, n = obs.shape[:2]

        def buf(*shape, dtype=torch.float32):
            return torch.empty((T, *shape), dtype=dtype, device=obs.device)

        traj = Transition(obs=buf(*obs.shape), raw_action=buf(b, n, 2), logp=buf(b, n),
                          value=buf(b, n), reward=buf(b, n), ep_done=buf(b, dtype=torch.bool),
                          agent_done=buf(b, n, dtype=torch.bool),
                          status=buf(b, n, dtype=torch.int32))
        for t in range(T):
            mean, log_std, value = model(obs)
            action, raw = sample_action(mean, log_std, self.noise_fn(mean.shape))
            logp, _ = logp_and_entropy(mean, log_std, raw)
            env_state, out = self.env.step(env_state, action)
            for dst, src in zip(traj, (obs, raw, logp, value, out.reward,
                                       out.terminated | out.truncated, out.done, out.status)):
                dst[t] = src
            obs = out.obs
        last_value = model(obs)[2]
        return env_state, obs, traj, last_value

    # ---------------------------------------------------------------------- gae
    def _gae(self, traj: Transition, last_value: torch.Tensor):
        cfg = self.cfg
        # the bootstrap is cut at episode ends and at per-agent done events:
        # a crash respawns the agent, which starts a new life
        done = (traj.ep_done[..., None] | traj.agent_done).float()        # (T, B, N)
        advs = torch.empty_like(traj.reward)
        gae = torch.zeros_like(last_value)
        next_value = last_value
        for t in reversed(range(traj.reward.shape[0])):
            nonterm = 1.0 - done[t]
            delta = traj.reward[t] + cfg.gamma * next_value * nonterm - traj.value[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterm * gae
            advs[t] = gae
            next_value = traj.value[t]
        return advs, advs + traj.value

    # ------------------------------------------------------------------- update
    def _loss(self, model: nn.Module, batch, actor_on: float = 1.0):
        obs, raw, old_logp, adv, ret, old_value = batch
        mean, log_std, value = model(obs)
        return self._ppo_loss(mean, log_std, value, raw, old_logp, adv, ret, old_value, actor_on)

    def _ppo_loss(self, mean, log_std, value, raw, old_logp, adv, ret, old_value, actor_on):
        """The clipped PPO loss of the policy's outputs on a batch, and its metrics."""
        cfg = self.cfg
        logp, entropy = logp_and_entropy(mean, log_std, raw)
        ratio = torch.exp(logp - old_logp)
        mean, std = self._adv_stats(adv)
        adv_n = (adv - mean) / (std + 1e-8)
        pg1 = ratio * adv_n
        pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clip = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
        ent = entropy.mean()
        total = actor_on * (pg_loss - cfg.ent_coef * ent) + cfg.vf_coef * v_loss
        metrics = dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent,
                       approx_kl=(old_logp - logp).mean())
        return total, metrics

    def _adv_stats(self, adv: torch.Tensor):
        """The minibatch's mean and population std of the advantages; on a
        mesh of more than one data rank, the global minibatch's, from
        all-reduced sums."""
        if self.mesh is None or self.data_axis.size == 1:
            return adv.mean(), adv.std(correction=0)
        count = adv.numel() * self.data_axis.size
        mean = axis_sum_(adv.sum(), self.data_axis) / count
        return mean, torch.sqrt(axis_sum_(((adv - mean) ** 2).sum(), self.data_axis) / count)

    def _minibatches(self, traj: Transition, advs: torch.Tensor, rets: torch.Tensor):
        """Per epoch, ``num_minibatches`` batches of ``_loss``: one permutation
        of the time axis per epoch, cut into equal slices."""
        cfg = self.cfg
        T, mb = cfg.rollout_len, cfg.num_minibatches
        size = T // mb
        data = (traj.obs, traj.raw_action, traj.logp, advs, rets, traj.value)
        for _ in range(cfg.update_epochs):
            perm = self.perm_fn(T)          # shuffle time only
            for i in range(mb):
                idx = perm[i * size:(i + 1) * size]
                yield tuple(x[idx] for x in data)

    def _update(self, ts: TrainState, traj: Transition, advs: torch.Tensor, rets: torch.Tensor):
        cfg = self.cfg
        T, mb = cfg.rollout_len, cfg.num_minibatches
        if T % mb:
            raise ValueError(f"rollout_len {T} is not a multiple of num_minibatches {mb}")
        per_step = cfg.update_epochs * mb
        params = [p for p in ts.model.parameters() if p.requires_grad]
        sums = torch.zeros(len(LOSS_METRICS), device=advs.device)
        for batch in self._minibatches(traj, advs, rets):
            actor_on = 1.0 if ts.update_count >= cfg.critic_warmup * per_step else 0.0
            loss, metrics = self._loss(ts.model, batch, actor_on)
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in params]
            if self.mesh is not None:
                average_gradients_(params, self.data_axis)
            if self.mesh is None or self.model_axis.size == 1:
                clip_by_global_norm_(grads, cfg.max_grad_norm)
            else:       # the TP-aware norm, where the model axis splits parameters
                clip_by_global_norm_(grads, cfg.max_grad_norm,
                                     global_grad_norm(params, self.model_axis))
            ts.optimizer.step()
            ts.update_count += 1
            sums += torch.stack([metrics[k].detach() for k in LOSS_METRICS])
        return ts, dict(zip(LOSS_METRICS, (sums / per_step).unbind()))

    # --------------------------------------------------------------- train step
    def _train(self, ts: TrainState, carry: tuple, split: Optional[Dict[str, float]]):
        """Rollout from ``carry`` (the arguments of ``_rollout`` after the
        model), GAE and the update: ``(ts, carry, metrics)``."""
        if split is not None:
            self._sync()
            t0 = time.perf_counter()
        *carry, traj, last_value = self._rollout(ts.model, *carry)
        if split is not None:
            self._sync()
            t1 = time.perf_counter()
            split["rollout_s"] = t1 - t0
        advs, rets = self._gae(traj, last_value)
        ts, metrics = self._update(ts, traj, advs, rets)
        if split is not None:
            self._sync()
            split["update_s"] = time.perf_counter() - t1
        metrics.update(trajectory_metrics(traj))
        return ts, tuple(carry), metrics

    def train_step(self, ts: TrainState, env_state, obs: torch.Tensor,
                   split: Optional[Dict[str, float]] = None):
        """One rollout + PPO update: ``(ts, env_state, obs, metrics)``, the
        metrics 0-d tensors on the device. Given a ``split`` dict, it waits
        for the device before, between and after the two halves and stores
        their seconds there as ``rollout_s`` and ``update_s`` (GAE included)."""
        ts, (env_state, obs), metrics = self._train(ts, (env_state, obs), split)
        return ts, env_state, obs, metrics

    def jit_train_step(self, mesh=None):
        """The counterpart of the JAX package's ``jit_train_step()``:
        ``step(ts, env_state, obs, split=None) -> (ts, env_state, obs,
        metrics)``, ``train_step``'s contract. On the card the rollout, GAE
        and each minibatch update replay CUDA graphs (``_GraphedTrainStep``);
        on the CPU it is ``train_step``. A ``mesh`` raises: ``distributed()``
        stays eager. With traffic the env step is the segmented one of
        ``VectorEnv.jit_step`` (the host reads the NPC width and steers the
        exact mode's loops between the graphs).

        The graphed step switches ``ts.optimizer`` to capturable Adam
        (utils/graphs.py::capturable_), whose float32 bias corrections agree
        with the eager Adam's to rounding, so the graphed update is held to
        the eager one within a tolerance and not bit for bit; the rollout is
        bit-equal."""
        if mesh is not None or self.mesh is not None:
            raise ValueError("jit_train_step graphs the one-process step; on a mesh, "
                             "distributed() runs the step eagerly")
        if self.device.type != "cuda":
            return self.train_step
        return _GraphedTrainStep(self)


class _GraphedTrainStep:
    """``PPOLearner.jit_train_step``'s step on the card: ``train_step`` as
    CUDA graphs of one pool.

      - One rollout step, as segments of one ``Segments``: the forward,
        the action sample and its log-prob (the ``act`` graph, whose
        result is carried in static buffers), then the env's ``step_body``
        with the segment runner, whose last segment also writes the
        trajectory, the env state, the observation and the step index
        (``_record``). Without traffic the env step is one segment; with
        traffic its NPC width and the exact mode's loop rounds are read by
        the host between its segments, as ``VectorEnv.jit_step`` does. The
        step index is a device counter that the last segment advances, so
        one set of graphs serves every t (one per t would capture
        ``rollout_len`` copies of the same ~700 launches). The action noise
        (``noise_fn``) and the env's draws are made eagerly before each
        step, one step's at a time as ``_rollout`` draws them (the Philox
        stream stays the same), and copied into static buffers.
      - The last value: one forward.
      - GAE and the trajectory's metrics.
      - One minibatch update: the forward, ``backward``, the clip (decided
        on the device) and Adam's step, the loss metrics summed into a
        static buffer. The epoch's permutation stays an eager ``perm_fn``
        draw; each minibatch's time indices are copied into a static index
        buffer before its replay. The critic-warmup gate is decided on the
        host from ``update_count``, so the update is captured once for each
        gate it meets: with the actor loss on, and masked.

    The graphs and their buffers are bound to one model, optimizer and set
    of shapes; another of any of them captures anew, as the JAX package's
    train.py re-jits at each curriculum stage."""

    def __init__(self, learner: PPOLearner):
        self.lrn = learner
        self.key = None

    def _bind(self, ts: TrainState, obs: torch.Tensor) -> None:
        lrn, cfg = self.lrn, self.lrn.cfg
        T, mb = cfg.rollout_len, cfg.num_minibatches
        if T % mb:
            raise ValueError(f"rollout_len {T} is not a multiple of num_minibatches {mb}")
        capturable_(ts.optimizer)
        self.pool = GraphPool(lrn.device)
        self.ts = ts
        self.params = [p for p in ts.model.parameters() if p.requires_grad]
        self.env_state = self.obs = self.draws = None      # made by their first stage()
        b, n = obs.shape[:2]

        def buf(*shape, dtype=torch.float32):
            return torch.empty((T, *shape), dtype=dtype, device=obs.device)

        self.traj = Transition(obs=buf(*obs.shape), raw_action=buf(b, n, 2), logp=buf(b, n),
                               value=buf(b, n), reward=buf(b, n),
                               ep_done=buf(b, dtype=torch.bool),
                               agent_done=buf(b, n, dtype=torch.bool),
                               status=buf(b, n, dtype=torch.int32))
        self.noise = torch.empty((b, n, 2), device=obs.device)
        self.t = torch.zeros((1,), dtype=torch.long, device=obs.device)
        self.last_value = torch.empty((b, n), device=obs.device)
        self.advs, self.rets = (torch.empty_like(self.traj.reward) for _ in range(2))
        self.idx = torch.empty((T // mb,), dtype=torch.long, device=obs.device)
        self.sums = torch.zeros(len(LOSS_METRICS), device=obs.device)
        self.traj_metrics = torch.empty(len(TRAJ_METRICS), device=obs.device)
        self.segments = Segments(self.pool, lrn.env.env.npc_stats)
        self.value = Graph(self._last_value, self.pool)
        self.gae = Graph(self._gae, self.pool)
        self.updates = {}           # actor_on -> the minibatch update's graph

    def _act(self, obs, noise):
        mean, log_std, value = self.ts.model(obs)
        action, raw = sample_action(mean, log_std, noise)
        logp, _ = logp_and_entropy(mean, log_std, raw)
        return action, raw, logp, value

    def _record(self, act, env_state, out):
        """The env step's result written into the static buffers, inside
        its last segment."""
        _, raw, logp, value = act
        for dst, src in zip(self.traj, (self.obs, raw, logp, value, out.reward,
                                        out.terminated | out.truncated, out.done, out.status)):
            dst.index_copy_(0, self.t, src[None])
        copy_tree_(self.env_state, env_state)
        self.obs.copy_(out.obs)
        self.t += 1

    @torch.no_grad()
    def _rollout_step(self):
        act = self.segments.carry(("act",), self._act, self.obs, self.noise)
        self.lrn.env.step_body(self.env_state, act[0], self.draws, run=self.segments,
                               finish=functools.partial(self._record, act))

    @torch.no_grad()
    def _last_value(self):
        self.last_value.copy_(self.ts.model(self.obs)[2])

    @torch.no_grad()
    def _gae(self):
        advs, rets = self.lrn._gae(self.traj, self.last_value)
        self.advs.copy_(advs)
        self.rets.copy_(rets)
        self.traj_metrics.copy_(torch.stack(list(trajectory_metrics(self.traj).values())))
        self.sums.zero_()

    def _update(self, actor_on: float):
        lrn, ts = self.lrn, self.ts
        traj = self.traj
        data = (traj.obs, traj.raw_action, traj.logp, self.advs, self.rets, traj.value)
        loss, metrics = lrn._loss(ts.model, tuple(x[self.idx] for x in data), actor_on)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_([p.grad for p in self.params], lrn.cfg.max_grad_norm)
        ts.optimizer.step()
        self.sums += torch.stack([metrics[k].detach() for k in LOSS_METRICS])

    def __call__(self, ts: TrainState, env_state, obs: torch.Tensor,
                 split: Optional[Dict[str, float]] = None):
        lrn, cfg = self.lrn, self.lrn.cfg
        key = (id(ts.model), id(ts.optimizer), tuple(obs.shape),
               tuple(tuple(t.shape) for t in leaves(env_state)))
        if key != self.key:
            self._bind(ts, obs)
            self.key = key
        if split is not None:
            lrn._sync()
            t0 = time.perf_counter()
        self.env_state, self.obs = stage(self.env_state, env_state), stage(self.obs, obs)
        self.t.zero_()
        for _ in range(cfg.rollout_len):
            self.noise.copy_(lrn.noise_fn(self.noise.shape))
            self.draws = stage(self.draws, lrn.env.draws())
            self._rollout_step()
        self.value()
        if split is not None:
            lrn._sync()
            t1 = time.perf_counter()
            split["rollout_s"] = t1 - t0
        self.gae()
        T, mb = cfg.rollout_len, cfg.num_minibatches
        size, per_step = T // mb, cfg.update_epochs * mb
        for _ in range(cfg.update_epochs):
            perm = lrn.perm_fn(T)
            for i in range(mb):
                self.idx.copy_(perm[i * size:(i + 1) * size])
                actor_on = 1.0 if ts.update_count >= cfg.critic_warmup * per_step else 0.0
                graph = self.updates.get(actor_on)
                if graph is None:
                    graph = self.updates[actor_on] = Graph(
                        lambda a=actor_on: self._update(a), self.pool)
                graph()
                ts.update_count += 1
        values = torch.cat([self.sums / per_step, self.traj_metrics])
        if split is not None:
            lrn._sync()
            split["update_s"] = time.perf_counter() - t1
        return ts, self.env_state, self.obs, dict(zip(LOSS_METRICS + TRAJ_METRICS,
                                                      values.unbind()))

    @property
    def graphs(self) -> dict:
        """The bound graphs by name, for their launch counts and capture times;
        the rollout step's by segment key."""
        out = {"rollout " + " ".join(map(str, k)): g for k, g in self.segments.graphs.items()}
        out.update(last_value=self.value, gae=self.gae)
        out.update({f"update_actor_{'on' if a else 'off'}": g for a, g in self.updates.items()})
        return out


def read_metrics(metrics: Dict[str, torch.Tensor], mesh=None) -> Dict[str, float]:
    """The metrics as Python floats, with one copy from the device; given
    the learner's mesh of more than one data rank, their means over the data
    ranks (one all-reduce)."""
    values = torch.stack([v.float() for v in metrics.values()])
    if mesh is not None:
        values = axis_mean(values, data_axis(mesh))
    return dict(zip(metrics, values.tolist()))
