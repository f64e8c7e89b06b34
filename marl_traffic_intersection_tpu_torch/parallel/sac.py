"""Off-policy SAC learner over the batched env.

Counterpart of marl_traffic_intersection_tpu/parallel/sac.py, run eagerly on
one device: twin Q critics with polyak targets, the reparameterised
tanh-Gaussian actor, and automatic temperature tuning to a target entropy.

  - The replay ring is preallocated on the device. Each env step inserts one
    (num_envs x num_agents)-row chunk; the capacity is rounded up to a chunk
    multiple, so every insert writes one aligned slice at ``ptr * chunk``.
    ``ptr`` advances the same way whatever the data, so it is a host integer;
    ``size`` is a device tensor, and sampling draws its indices on the device
    from ``max(size, 1)`` with the learner's generator, so no step reads the
    device.
  - ``_update`` takes all three losses at the pre-update parameters: the
    target and the actor loss read the critics before their step and
    ``exp(log_alpha)`` from before the step; the alpha loss takes the actor's
    mean log-prob detached.
  - Until the ring holds ``warmup`` transitions the gradients are multiplied
    by ``ready`` = 0 (a device tensor), and every optimizer still steps, with
    zero gradients rather than none, so Adam's step count advances as optax's
    does; the polyak rate is ``tau * ready``.
  - ``train_step`` is a Python loop of ``steps_per_call`` x [env step,
    insert, update]; ``collect`` fills the ring from any policy
    (demonstration seeding) without updates.

The action noise and the sample indices come from ``noise_fn`` and
``index_fn`` (default: draws on the learner's generator), so tests can feed
the JAX package's draws. Every optimizer is ``torch.optim.Adam(eps=1e-8)``,
optax's ``adam``.

``distributed(mesh, model_kind)`` binds the learner to a ``(data, model)``
mesh (parallel/mesh.py) and returns ``(step, shard_ts, shard_env)``, as the
JAX package's ``jit_train_step(mesh)`` does:

  - the env steps this rank's envs, and the rollout's action noise is drawn
    for the global batch and cut to them (envs/vector.py);
  - the ring is split over the data ranks by env: each slot holds, on each
    rank, the rows of that rank's envs. ``chunk``, ``capacity`` and ``size``
    stay global, and a global row ``slot * chunk + env * N + agent`` lives on
    the rank holding ``env``;
  - every rank draws the same global sample indices; each reads the rows it
    holds and one all-gather over the data ranks assembles the batch, which
    is then bit-equal to the single-process ring's sample at those indices
    (at one data rank the ring is whole and is indexed as in one process);
  - the actor is split over the model axis by ``model_kind``'s rule and the
    twin critic and its target by ``sac_q``. Every data rank holds the same
    batch, so their gradients are already equal and are not averaged.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.actor_critic import draw_noise
from ..models.sac import SquashedGaussianActor, TwinQCritic, sample_squashed
from .mesh import data_axis, global_rows, shard_batch_tree, shard_model_


@dataclass(frozen=True)
class SACConfig:
    gamma: float = 0.99
    tau: float = 0.005                    # polyak target rate
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    target_entropy: Optional[float] = None   # default: -act_dim
    batch_size: int = 256
    buffer_capacity: int = 1 << 19        # transitions (rounded up to a chunk multiple)
    warmup: int = 2048                    # transitions before updates start
    steps_per_call: int = 8               # env steps (and updates) per train_step


@dataclass
class ReplayBuffer:
    obs: torch.Tensor          # (C, 127)
    action: torch.Tensor       # (C, 2)
    reward: torch.Tensor       # (C,)
    next_obs: torch.Tensor     # (C, 127)
    done: torch.Tensor         # (C,) f32 bootstrap cut
    ptr: int                   # the next insert's slot, in chunks
    size: torch.Tensor         # 0-d int64 on the device: transitions currently valid


@dataclass
class SACState:
    actor: nn.Module
    critic: TwinQCritic
    critic_target: TwinQCritic
    log_alpha: nn.Parameter
    actor_opt: torch.optim.Optimizer
    q_opt: torch.optim.Optimizer
    alpha_opt: torch.optim.Optimizer
    buffer: ReplayBuffer
    update_count: int = 0


class SACLearner:
    def __init__(self, vec_env, cfg: SACConfig = SACConfig(),
                 actor: Optional[nn.Module] = None, critic: Optional[TwinQCritic] = None,
                 seed: int = 0,
                 noise_fn: Optional[Callable[[torch.Size], torch.Tensor]] = None,
                 index_fn: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None):
        self.env = vec_env
        self.cfg = cfg
        self.actor = actor if actor is not None else SquashedGaussianActor()
        self.critic = critic if critic is not None else TwinQCritic()
        self.device = vec_env.env.device
        self.n_agents = vec_env.env.config.num_agents
        self.chunk = vec_env.num_envs * self.n_agents
        cap = max(cfg.buffer_capacity, self.chunk)
        self.capacity = ((cap + self.chunk - 1) // self.chunk) * self.chunk
        self.target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                               else -float(self.actor.act_dim))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise_fn = noise_fn or (lambda shape: draw_noise(shape, self.generator))
        self.act_noise_fn = self.noise_fn        # the rollout's; the update's is noise_fn
        self.index_fn = index_fn or self._draw_indices
        self.mesh = None
        self.local_chunk = self.chunk            # ring rows of one slot on this rank

    def distributed(self, mesh, model_kind: str = "sac"):
        """Bind the learner to ``mesh``: ``(step, shard_ts, shard_env)``, see
        the module docstring. ``shard_ts`` takes a state of ``init`` (the
        whole ring) and keeps this rank's rows and parameter shards."""
        if self.mesh is None:
            self.mesh, self.data_axis = mesh, data_axis(mesh)
            self.env = self.env.with_mesh(mesh)
            self.local_chunk = self.chunk // self.data_axis.size
            draw = self.act_noise_fn
            self.act_noise_fn = lambda shape: global_rows(self.data_axis, draw, shape)
        elif self.mesh is not mesh:
            raise ValueError("the learner is bound to another mesh")

        def shard_ts(ts: SACState) -> SACState:
            shard_model_(ts.actor, model_kind, mesh, [ts.actor_opt])
            shard_model_(ts.critic, "sac_q", mesh, [ts.q_opt])
            shard_model_(ts.critic_target, "sac_q", mesh)
            buf = ts.buffer
            if buf.obs.shape[0] == self.capacity:
                rank, k = self.data_axis.rank, self.local_chunk
                for f in ("obs", "action", "reward", "next_obs", "done"):
                    x = getattr(buf, f)
                    x = x.reshape(-1, self.chunk, *x.shape[1:])[:, rank * k:(rank + 1) * k]
                    setattr(buf, f, x.reshape(-1, *x.shape[2:]).clone())
            return ts

        def shard_env(*carry):
            return shard_batch_tree(mesh, carry)

        return self.train_step, shard_ts, shard_env

    def _draw_indices(self, n: int, size: torch.Tensor) -> torch.Tensor:
        """n uniform indices in [0, max(size, 1)), drawn on the device."""
        draws = torch.randint(0, 1 << 62, (n,), generator=self.generator, device=self.device)
        return draws % size.clamp(min=1)

    # ----------------------------------------------------------------- init
    def init(self) -> SACState:
        """The networks on the env's device, fresh optimizers, an empty ring."""
        actor, critic = self.actor.to(self.device), self.critic.to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = nn.Parameter(torch.log(torch.tensor(self.cfg.init_alpha,
                                                        device=self.device)))
        C, d = self.capacity, self.device
        buffer = ReplayBuffer(
            obs=torch.zeros((C, 127), device=d), action=torch.zeros((C, actor.act_dim), device=d),
            reward=torch.zeros((C,), device=d), next_obs=torch.zeros((C, 127), device=d),
            done=torch.zeros((C,), device=d), ptr=0,
            size=torch.zeros((), dtype=torch.int64, device=d))
        adam = lambda params, lr: torch.optim.Adam(params, lr=lr, eps=1e-8)
        return SACState(actor=actor, critic=critic, critic_target=target, log_alpha=log_alpha,
                        actor_opt=adam(actor.parameters(), self.cfg.lr),
                        q_opt=adam(critic.parameters(), self.cfg.lr),
                        alpha_opt=adam([log_alpha], self.cfg.alpha_lr), buffer=buffer)

    # --------------------------------------------------------------- buffer
    def _insert(self, buf: ReplayBuffer, obs, action, reward, next_obs, done) -> None:
        """Write one (chunk,)-row transition block at the aligned ring slot
        (this rank's rows of it on a mesh)."""
        rows = slice(buf.ptr * self.local_chunk, (buf.ptr + 1) * self.local_chunk)
        for dst, src in ((buf.obs, obs), (buf.action, action), (buf.reward, reward),
                         (buf.next_obs, next_obs), (buf.done, done)):
            dst[rows] = src
        buf.ptr = (buf.ptr + 1) % (self.capacity // self.chunk)
        buf.size.add_(self.chunk).clamp_(max=self.capacity)

    def _insert_step(self, buf: ReplayBuffer, obs, action, out) -> None:
        """Insert an env step's transitions, one row per (env, agent)."""
        done = (out.terminated | out.truncated)[:, None] | out.done
        flat = lambda x: x.reshape((self.local_chunk,) + x.shape[2:])
        self._insert(buf, flat(obs), flat(action), flat(out.reward), flat(out.obs),
                     flat(done.float()))

    def _sample(self, buf: ReplayBuffer, n: int):
        idx = self.index_fn(n, buf.size)
        fields = (buf.obs, buf.action, buf.reward, buf.next_obs, buf.done)
        if self.mesh is None or self.data_axis.size == 1:
            return tuple(x[idx] for x in fields)
        # the rank holding global row idx, and that row's place in its ring
        slot, within = idx // self.chunk, idx % self.chunk
        owner, local = within // self.local_chunk, slot * self.local_chunk + within % self.local_chunk
        widths = [x[0].numel() for x in fields]
        mine = torch.cat([x[local].reshape(n, -1) for x in fields], 1)
        parts = [torch.empty_like(mine) for _ in range(self.data_axis.size)]
        torch.distributed.all_gather(parts, mine, group=self.data_axis.group)
        rows = torch.stack(parts)[owner, torch.arange(n, device=idx.device)]
        return tuple(r.reshape(n, *x.shape[1:]) for r, x in zip(rows.split(widths, 1), fields))

    # --------------------------------------------------------------- update
    def _update(self, ts: SACState) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        obs, action, reward, next_obs, done = self._sample(ts.buffer, cfg.batch_size)
        alpha = ts.log_alpha.detach().exp()

        with torch.no_grad():                                   # targets
            mean2, log_std2 = ts.actor(next_obs)
            a2, logp2 = sample_squashed(mean2, log_std2, self.noise_fn(mean2.shape))
            q2 = ts.critic_target(next_obs, a2).amin(0) - alpha * logp2
            y = reward + cfg.gamma * (1.0 - done) * q2

        q_params = list(ts.critic.parameters())
        q = ts.critic(obs, action)                              # (2, batch)
        q_loss = ((q - y[None, :]) ** 2).mean()
        q_grads = torch.autograd.grad(q_loss, q_params)

        a_params = list(ts.actor.parameters())
        mean, log_std = ts.actor(obs)
        a_pi, logp_pi = sample_squashed(mean, log_std, self.noise_fn(mean.shape))
        q_pi = ts.critic(obs, a_pi).amin(0)                     # the critics before their step
        actor_loss = (alpha * logp_pi - q_pi).mean()
        a_grads = torch.autograd.grad(actor_loss, a_params)

        mean_logp = logp_pi.mean().detach()
        alpha_loss = -(ts.log_alpha.exp() * (mean_logp + self.target_entropy))
        (al_grad,) = torch.autograd.grad(alpha_loss, [ts.log_alpha])

        # gate everything until warmup transitions are in the ring; Adam
        # still steps (with zero gradients), so its step count advances
        ready = (ts.buffer.size >= cfg.warmup).float()
        for params, grads, opt in ((q_params, q_grads, ts.q_opt), (a_params, a_grads, ts.actor_opt),
                                   ([ts.log_alpha], [al_grad], ts.alpha_opt)):
            for p, g in zip(params, grads):
                p.grad = g * ready
            opt.step()

        with torch.no_grad():
            targets = list(ts.critic_target.parameters())
            moved = torch._foreach_sub([p.detach() for p in q_params], targets)
            torch._foreach_add_(targets, torch._foreach_mul(moved, cfg.tau * ready))
        ts.update_count += 1
        return dict(q_loss=q_loss.detach(), actor_loss=actor_loss.detach(),
                    alpha=ts.log_alpha.detach().exp(), mean_q=q.detach().mean(),
                    entropy=-mean_logp, buffer_size=ts.buffer.size.float())

    # ------------------------------------------------------ demo collection
    @torch.no_grad()
    def collect(self, ts: SACState, env_state, obs: torch.Tensor,
                policy_fn: Callable[[torch.Tensor], torch.Tensor], steps: int):
        """Fill the ring with ``steps`` env steps of ``policy_fn(obs) ->
        action`` (demonstration seeding, e.g. from a trained PPO actor); no
        updates. Returns ``(ts, env_state, obs)``."""
        for _ in range(steps):
            action = policy_fn(obs)
            env_state, out = self.env.step(env_state, action)
            self._insert_step(ts.buffer, obs, action, out)
            obs = out.obs
        return ts, env_state, obs

    # ----------------------------------------------------------- train step
    def train_step(self, ts: SACState, env_state, obs: torch.Tensor):
        """``steps_per_call`` x [env step, insert, update]: ``(ts, env_state,
        obs, metrics)``, the last update's metrics and the last step's mean
        reward as 0-d tensors on the device."""
        for _ in range(self.cfg.steps_per_call):
            with torch.no_grad():
                mean, log_std = ts.actor(obs)
                action, _ = sample_squashed(mean, log_std, self.act_noise_fn(mean.shape))
                env_state, out = self.env.step(env_state, action)
                self._insert_step(ts.buffer, obs, action, out)
            metrics = self._update(ts)
            metrics["mean_reward"] = out.reward.mean()
            obs = out.obs
        return ts, env_state, obs, metrics

