"""PPO learner over the batched env: rollout, GAE and the clipped-PPO update.

Counterpart of marl_traffic_intersection_tpu/parallel/ppo.py. One
``train_step`` is a rollout of ``rollout_len`` env steps with the policy in
the loop (the env step launches kernels K1 and K3 and the libm kernels), GAE
backwards over the trajectory, then ``update_epochs`` epochs of
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

The step is written once, ``TrainStep``, and run by a segment runner
(utils/graphs.py): eagerly by ``train_step`` (the CPU, the card, a mesh),
as CUDA graph replays by ``jit_train_step()`` on the card. ``rollout`` and
``update`` run its rollout alone and its update alone.

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
from ..utils.graphs import (EAGER, Segments, capturable_, clone_tree, copy_tree_, leaves,
                            stage)
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
        self.eager = TrainStep(self)

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
    def _trajectory(self, obs: torch.Tensor) -> Transition:
        """Empty (T, ...) trajectory buffers of a rollout from ``obs``."""
        T, (b, n) = self.cfg.rollout_len, obs.shape[:2]

        def buf(*shape, dtype=torch.float32):
            return torch.empty((T, *shape), dtype=dtype, device=obs.device)

        return Transition(obs=buf(*obs.shape), raw_action=buf(b, n, 2), logp=buf(b, n),
                          value=buf(b, n), reward=buf(b, n), ep_done=buf(b, dtype=torch.bool),
                          agent_done=buf(b, n, dtype=torch.bool),
                          status=buf(b, n, dtype=torch.int32))

    def _transition(self, act, out, obs: torch.Tensor):
        """One step's trajectory row, from the act (``TrainStep._act``), the
        env's ``out`` and the observation acted on; and the carry after the
        step besides the observation (none here)."""
        _, raw, logp, value = act
        return (obs, raw, logp, value, out.reward, out.terminated | out.truncated, out.done,
                out.status), ()

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

    def _minibatch_indices(self) -> list:
        """One epoch's minibatches: one permutation of the time axis, cut
        into ``num_minibatches`` equal slices of time indices."""
        T, mb = self.cfg.rollout_len, self.cfg.num_minibatches
        size, perm = T // mb, self.perm_fn(T)          # shuffle time only
        return [perm[i * size:(i + 1) * size] for i in range(mb)]

    def _minibatch(self, traj: Transition, advs: torch.Tensor, rets: torch.Tensor,
                   idx: torch.Tensor) -> tuple:
        """``_loss``'s batch at the time indices ``idx``."""
        return tuple(x[idx] for x in (traj.obs, traj.raw_action, traj.logp, advs, rets,
                                      traj.value))

    # ------------------------------------------------------------- entry points
    def train_step(self, ts: TrainState, env_state, obs: torch.Tensor,
                   split: Optional[Dict[str, float]] = None):
        """One rollout + PPO update: ``(ts, env_state, obs, metrics)``, the
        metrics 0-d tensors on the device. Given a ``split`` dict, it waits
        for the device before, between and after the two halves and stores
        their seconds there as ``rollout_s`` and ``update_s`` (GAE included).
        The returned env state and observation are the step's buffers
        (``TrainStep``), which the next call overwrites."""
        return self.eager(ts, env_state, obs, split)

    def rollout(self, ts: TrainState, *carry):
        """The rollout alone from ``carry`` (env state, observation [,
        hidden state]): ``(*carry, traj, last_value)``, the step's buffers."""
        carry, traj, last_value = self.eager.rollout(ts, carry)
        return (*carry, traj, last_value)

    def update(self, ts: TrainState, traj, advs: torch.Tensor, rets: torch.Tensor):
        """The update alone, on a given trajectory, advantages and returns:
        ``(ts, metrics)``, the loss metrics' means over the minibatches."""
        return ts, self.eager.update(ts, traj, advs, rets)

    def jit_train_step(self, mesh=None):
        """The counterpart of the JAX package's ``jit_train_step()``:
        ``step(ts, env_state, obs, split=None) -> (ts, env_state, obs,
        metrics)``, ``train_step``'s contract. On the card it is a
        ``TrainStep`` whose parts replay CUDA graphs; on the CPU it is
        ``train_step``. A ``mesh`` raises: ``distributed()`` stays eager.

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
        return TrainStep(self, graphed=True)


class TrainStep:
    """The train step, written once, its parts run by a segment runner
    (utils/graphs.py): ``EAGER`` for ``train_step`` (every part a call),
    a ``Segments`` of one graph pool for ``jit_train_step()`` on the card
    (every part a CUDA graph replay). The parts:

      - one rollout step: the forward, the action sample and its log-prob
        (``act``, carried), then the env's ``step_body`` on the runner,
        whose last segment also writes the trajectory's row, the carry
        (env state, observation [, hidden state]) and the step index
        (``_record``). With traffic the host reads the NPC width and steers
        the exact mode's loops between the env step's segments, as
        ``VectorEnv.jit_step`` does. The step index is a device counter, so
        one set of graphs serves every t. The action noise and the env's
        draws are made eagerly before each step and copied into buffers;
      - the last value; GAE and the trajectory's metrics;
      - one minibatch update: the forward, ``backward``, on a mesh the
        gradients' mean over the data ranks, the clip (decided on the
        device; the TP-aware norm where the model axis splits parameters),
        Adam's step and the loss metrics' sums. Each epoch's permutation is
        an eager ``perm_fn`` draw, each minibatch's indices are copied into
        a buffer, and the critic-warmup gate is decided on the host from
        ``update_count``: the update is a part for each gate it meets.

    The learner's hooks fill in the model family: ``_trajectory``,
    ``_transition``, ``_gae``, ``_minibatch_indices``, ``_minibatch`` and
    ``_loss``. The buffers (the last call's ``traj``, ``last_value``,
    ``advs``, ``rets``, ...) and a graphed step's graphs are bound to one
    model, optimizer and set of shapes; another of any of them binds anew,
    as the JAX package's train.py re-jits at each curriculum stage."""

    def __init__(self, learner: PPOLearner, graphed: bool = False):
        self.lrn, self.graphed = learner, graphed
        self.run = EAGER
        self.key = None

    def _bind(self, ts: TrainState, tree, trajectory: Callable[[], tuple]) -> None:
        """Bind to ``ts``; at another model, optimizer or shapes of ``tree``
        the buffers are made anew, the trajectory's by ``trajectory()``."""
        self.ts = ts
        key = (id(ts.model), id(ts.optimizer), tuple(tuple(t.shape) for t in leaves(tree)))
        if key == self.key:
            return
        lrn, cfg = self.lrn, self.lrn.cfg
        T, mb = cfg.rollout_len, cfg.num_minibatches
        if T % mb:
            raise ValueError(f"rollout_len {T} is not a multiple of num_minibatches {mb}")
        if self.graphed:
            capturable_(ts.optimizer)
            self.run = Segments.on(lrn.device, lrn.env.env.npc_stats)
        self.key = key
        self.params = [p for p in ts.model.parameters() if p.requires_grad]
        self.traj = traj = trajectory()
        dev = traj.reward.device
        # made by their first stage()
        self.env_state = self.obs = self.extra = self.draws = self.idx = None
        self.noise = torch.empty_like(traj.raw_action[0])
        self.t = torch.zeros((1,), dtype=torch.long, device=dev)
        self.last_value = torch.empty_like(traj.value[0])
        self.advs, self.rets = (torch.empty_like(traj.reward) for _ in range(2))
        self.sums = torch.zeros(len(LOSS_METRICS), device=dev)
        self.traj_metrics = torch.empty(len(TRAJ_METRICS), device=dev)

    def __call__(self, ts: TrainState, env_state, obs: torch.Tensor,
                 split: Optional[Dict[str, float]] = None):
        """``PPOLearner.train_step``'s contract."""
        ts, (env_state, obs), metrics = self.train(ts, (env_state, obs), split)
        return ts, env_state, obs, metrics

    def train(self, ts: TrainState, carry: tuple, split: Optional[Dict[str, float]] = None):
        """Rollout from ``carry`` (env state, observation [, hidden state]),
        GAE and the update: ``(ts, carry, metrics)``; ``split`` as in
        ``PPOLearner.train_step``."""
        lrn = self.lrn
        self._bind(ts, carry, lambda: lrn._trajectory(*carry[1:]))
        if split is not None:
            lrn._sync()
            t0 = time.perf_counter()
        self._rollout(carry)
        if split is not None:
            lrn._sync()
            t1 = time.perf_counter()
            split["rollout_s"] = t1 - t0
        self.run(("gae",), self._gae)
        values = torch.cat([self._learn(), self.traj_metrics])
        if split is not None:
            lrn._sync()
            split["update_s"] = time.perf_counter() - t1
        return ts, (self.env_state, self.obs, *self.extra), dict(
            zip(LOSS_METRICS + TRAJ_METRICS, values.unbind()))

    def rollout(self, ts: TrainState, carry: tuple):
        """The rollout alone: ``(carry, traj, last_value)``."""
        self._bind(ts, carry, lambda: self.lrn._trajectory(*carry[1:]))
        self._rollout(carry)
        return (self.env_state, self.obs, *self.extra), self.traj, self.last_value

    def update(self, ts: TrainState, traj, advs: torch.Tensor, rets: torch.Tensor) -> dict:
        """The update alone on ``traj``, ``advs`` and ``rets``: the loss
        metrics' means."""
        self._bind(ts, traj, lambda: clone_tree(traj))
        copy_tree_(self.traj, traj)
        self.advs.copy_(advs)
        self.rets.copy_(rets)
        self.sums.zero_()
        return dict(zip(LOSS_METRICS, self._learn().unbind()))

    @torch.no_grad()
    def _rollout(self, carry: tuple) -> None:
        lrn = self.lrn
        self.env_state, self.obs = stage(self.env_state, carry[0]), stage(self.obs, carry[1])
        self.extra = stage(self.extra, tuple(carry[2:]))
        self.t.zero_()
        for _ in range(lrn.cfg.rollout_len):
            self.noise.copy_(lrn.noise_fn(self.noise.shape))
            self.draws = stage(self.draws, lrn.env.draws())
            act = self.run.carry(("act",), self._act, self.obs, self.noise, *self.extra)
            lrn.env.step_body(self.env_state, act[0], self.draws, run=self.run,
                              finish=functools.partial(self._record, act))
        self.run(("last_value",), self._last_value)

    def _act(self, obs, noise, *extra):
        mean, log_std, value, *carry = self.ts.model(obs, *extra)
        action, raw = sample_action(mean, log_std, noise)
        logp, _ = logp_and_entropy(mean, log_std, raw)
        return (action, raw, logp, value, *carry)

    def _record(self, act, env_state, out):
        """The env step's result written into the static buffers, inside
        its last segment."""
        row, extra = self.lrn._transition(act, out, self.obs, *self.extra)
        for dst, src in zip(self.traj, row):
            dst.index_copy_(0, self.t, src[None])
        copy_tree_(self.env_state, env_state)
        self.obs.copy_(out.obs)
        copy_tree_(self.extra, extra)
        self.t += 1

    def _last_value(self):
        self.last_value.copy_(self.ts.model(self.obs, *self.extra)[2])

    @torch.no_grad()
    def _gae(self):
        advs, rets = self.lrn._gae(self.traj, self.last_value)
        self.advs.copy_(advs)
        self.rets.copy_(rets)
        self.traj_metrics.copy_(torch.stack(list(trajectory_metrics(self.traj).values())))
        self.sums.zero_()

    def _learn(self) -> torch.Tensor:
        """``update_epochs`` epochs of minibatch updates: the loss metrics'
        means."""
        lrn, ts, cfg = self.lrn, self.ts, self.lrn.cfg
        per_step = cfg.update_epochs * cfg.num_minibatches
        for _ in range(cfg.update_epochs):
            for idx in lrn._minibatch_indices():
                self.idx = stage(self.idx, idx)
                on = ts.update_count >= cfg.critic_warmup * per_step
                self.run((f"update_actor_{'on' if on else 'off'}",),
                         functools.partial(self._update, 1.0 if on else 0.0))
                ts.update_count += 1
        return self.sums / per_step

    def _update(self, actor_on: float):
        lrn, ts, params = self.lrn, self.ts, self.params
        # the batch is not kept past the loss: its observations (a quarter of
        # the trajectory's) are free again for the backward pass
        loss, metrics = lrn._loss(ts.model, lrn._minibatch(self.traj, self.advs, self.rets,
                                                           self.idx), actor_on)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if lrn.mesh is not None:
            average_gradients_(params, lrn.data_axis)
        grads = [p.grad for p in params]
        if lrn.mesh is None or lrn.model_axis.size == 1:
            clip_by_global_norm_(grads, lrn.cfg.max_grad_norm)
        else:       # the TP-aware norm, where the model axis splits parameters
            clip_by_global_norm_(grads, lrn.cfg.max_grad_norm,
                                 global_grad_norm(params, lrn.model_axis))
        ts.optimizer.step()
        self.sums += torch.stack([metrics[k].detach() for k in LOSS_METRICS])

    @property
    def graphs(self) -> dict:
        """The bound graphs by name (a graphed step's), for their launch
        counts and capture times: the learner's parts by theirs, the rollout
        step's segments as ``rollout <key>``."""
        return {k[0] if k[0] in _PARTS else "rollout " + " ".join(map(str, k)): g
                for k, g in getattr(self.run, "graphs", {}).items()}


_PARTS = ("last_value", "gae", "update_actor_on", "update_actor_off")


def read_metrics(metrics: Dict[str, torch.Tensor], mesh=None) -> Dict[str, float]:
    """The metrics as Python floats, with one copy from the device; given
    the learner's mesh of more than one data rank, their means over the data
    ranks (one all-reduce)."""
    values = torch.stack([v.float() for v in metrics.values()])
    if mesh is not None:
        values = axis_mean(values, data_axis(mesh))
    return dict(zip(metrics, values.tolist()))
