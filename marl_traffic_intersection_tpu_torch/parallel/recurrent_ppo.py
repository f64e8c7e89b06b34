"""Truncated-BPTT PPO for the recurrent (GRU) model family.

Counterpart of marl_traffic_intersection_tpu/parallel/recurrent_ppo.py, run
eagerly on one device. It differs from the feedforward learner (ppo.py) in
three places, and takes GAE, the clipped losses, optax's global-norm clip,
Adam and ``critic_warmup`` from it:

  - the rollout carries the GRU hidden state and zeroes it at agent life
    boundaries (``out.done | (terminated | truncated)[:, None]``: crash
    respawn, success, episode auto-reset), so memory never leaks across
    lives; each step's pre-step hidden state is stored in the trajectory;
  - minibatches are contiguous time chunks: the update cuts T into
    ``num_minibatches`` chunks, and each loss replays the GRU over its chunk
    from the chunk's stored entry hidden state, detached (truncated BPTT),
    zeroing it at the stored life boundaries as the rollout did;
  - each epoch permutes only the chunk order, with ``perm_fn`` (default
    ``torch.randperm`` on the learner's permutation generator).

``train_step(ts, env_state, obs, h)`` returns ``(ts, env_state, obs, h,
metrics)``. ``distributed(mesh, "gru")`` is the feedforward learner's: the
hidden state is a carry that ``shard_env`` cuts to the rank's envs like the
observation, and every rank draws the same chunk order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..models.actor_critic import logp_and_entropy, sample_action
from .ppo import PPOLearner, TrainState


class RecTransition(NamedTuple):
    obs: torch.Tensor          # (T, B, N, 127)
    h_in: torch.Tensor         # (T, B, N, H) pre-step hidden state
    raw_action: torch.Tensor   # (T, B, N, 2)
    logp: torch.Tensor         # (T, B, N)
    value: torch.Tensor        # (T, B, N)
    reward: torch.Tensor       # (T, B, N)
    ep_done: torch.Tensor      # (T, B)
    agent_done: torch.Tensor   # (T, B, N)
    done: torch.Tensor         # (T, B, N) life boundary: resets the hidden state next step
    status: torch.Tensor       # (T, B, N)


def _carry_on(h: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """The hidden state zeroed where ``done``."""
    return h * (1.0 - done.float())[..., None]


class RecurrentPPOLearner(PPOLearner):
    def initial_hidden(self) -> torch.Tensor:
        return self.model.initial_hidden(self.env.num_envs, self.env.env.config.num_agents,
                                         device=self.device)

    # ------------------------------------------------------------------ rollout
    @torch.no_grad()
    def _rollout(self, model: nn.Module, env_state, obs: torch.Tensor, h: torch.Tensor):
        T = self.cfg.rollout_len
        b, n = obs.shape[:2]

        def buf(*shape, dtype=torch.float32):
            return torch.empty((T, *shape), dtype=dtype, device=obs.device)

        traj = RecTransition(obs=buf(*obs.shape), h_in=buf(*h.shape), raw_action=buf(b, n, 2),
                             logp=buf(b, n), value=buf(b, n), reward=buf(b, n),
                             ep_done=buf(b, dtype=torch.bool),
                             agent_done=buf(b, n, dtype=torch.bool),
                             done=buf(b, n, dtype=torch.bool), status=buf(b, n, dtype=torch.int32))
        for t in range(T):
            mean, log_std, value, h2 = model(obs, h)
            action, raw = sample_action(mean, log_std, self.noise_fn(mean.shape))
            logp, _ = logp_and_entropy(mean, log_std, raw)
            env_state, out = self.env.step(env_state, action)
            ep_done = out.terminated | out.truncated
            done = out.done | ep_done[:, None]
            for dst, src in zip(traj, (obs, h, raw, logp, value, out.reward, ep_done, out.done,
                                       done, out.status)):
                dst[t] = src
            obs, h = out.obs, _carry_on(h2, done)
        last_value = model(obs, h)[2]
        return env_state, obs, h, traj, last_value

    # --------------------------------------------------------------- chunk loss
    def _loss(self, model: nn.Module, batch, actor_on: float = 1.0):
        obs, h0, done, raw, old_logp, adv, ret, old_value = batch
        h, means, values = h0.detach(), [], []
        for t in range(obs.shape[0]):
            mean, log_std, value, h2 = model(obs[t], h)
            means.append(mean)
            values.append(value)
            h = _carry_on(h2, done[t])
        return self._ppo_loss(torch.stack(means), log_std, torch.stack(values),
                              raw, old_logp, adv, ret, old_value, actor_on)

    # ------------------------------------------------------------------- update
    def _minibatches(self, traj: RecTransition, advs: torch.Tensor, rets: torch.Tensor):
        """Per epoch, the ``num_minibatches`` contiguous time chunks in a
        permuted order; each batch carries its chunk's entry hidden state."""
        cfg = self.cfg
        mb = cfg.num_minibatches
        chunk = cfg.rollout_len // mb

        def chunks(x):          # (T, ...) -> (mb, chunk, ...)
            return x.reshape(mb, chunk, *x.shape[1:])

        data = (chunks(traj.obs), traj.h_in[::chunk], chunks(traj.done),
                chunks(traj.raw_action), chunks(traj.logp), chunks(advs), chunks(rets),
                chunks(traj.value))
        for _ in range(cfg.update_epochs):
            perm = self.perm_fn(mb)         # shuffle the chunk order only
            for i in range(mb):
                idx = perm[i:i + 1]         # a device index: no read on the host
                yield tuple(x[idx][0] for x in data)

    # --------------------------------------------------------------- train step
    def train_step(self, ts: TrainState, env_state, obs: torch.Tensor, h: torch.Tensor,
                   split: Optional[Dict[str, float]] = None):
        """One rollout + truncated-BPTT PPO update: ``(ts, env_state, obs, h,
        metrics)``; ``split`` as in ``PPOLearner.train_step``."""
        ts, (env_state, obs, h), metrics = self._train(ts, (env_state, obs, h), split)
        return ts, env_state, obs, h, metrics

    def jit_train_step(self, mesh=None):
        """Not graphed yet (the JAX package's ``RecurrentPPOLearner`` jits
        its step): ``train_step`` runs eagerly, and ROADMAP queues the graph."""
        raise NotImplementedError("RecurrentPPOLearner has no graphed step yet; "
                                  "train_step runs it eagerly")
