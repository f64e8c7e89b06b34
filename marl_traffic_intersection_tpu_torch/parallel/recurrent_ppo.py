"""Truncated-BPTT PPO for the recurrent (GRU) model family.

Counterpart of marl_traffic_intersection_tpu/parallel/recurrent_ppo.py, run
eagerly. It differs from the feedforward learner (ppo.py) in three places,
each made by overriding hooks of its one ``TrainStep``, and takes GAE, the
clipped losses, optax's global-norm clip, Adam and ``critic_warmup`` from
it:

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
    def _trajectory(self, obs: torch.Tensor, h: torch.Tensor) -> RecTransition:
        ff = super()._trajectory(obs)
        return RecTransition(**ff._asdict(), done=torch.empty_like(ff.agent_done),
                             h_in=torch.empty((self.cfg.rollout_len, *h.shape), device=h.device))

    def _transition(self, act, out, obs: torch.Tensor, h: torch.Tensor):
        """The row stores the pre-step hidden state and the life boundary;
        the hidden state carried on is zeroed there."""
        _, raw, logp, value, h2 = act
        ep_done = out.terminated | out.truncated
        done = out.done | ep_done[:, None]
        return (obs, h, raw, logp, value, out.reward, ep_done, out.done, done,
                out.status), (_carry_on(h2, done),)

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
    def _minibatch_indices(self) -> list:
        """One epoch's minibatches: the ``num_minibatches`` contiguous time
        chunks in a permuted order, each a device index (no host read)."""
        mb = self.cfg.num_minibatches
        perm = self.perm_fn(mb)             # shuffle the chunk order only
        return [perm[i:i + 1] for i in range(mb)]

    def _minibatch(self, traj: RecTransition, advs: torch.Tensor, rets: torch.Tensor,
                   idx: torch.Tensor) -> tuple:
        """The chunk ``idx`` with its entry hidden state."""
        mb = self.cfg.num_minibatches
        chunk = self.cfg.rollout_len // mb

        def chunks(x):          # (T, ...) -> (mb, chunk, ...)
            return x.reshape(mb, chunk, *x.shape[1:])

        data = (chunks(traj.obs), traj.h_in[::chunk], chunks(traj.done),
                chunks(traj.raw_action), chunks(traj.logp), chunks(advs), chunks(rets),
                chunks(traj.value))
        return tuple(x[idx][0] for x in data)

    # --------------------------------------------------------------- train step
    def train_step(self, ts: TrainState, env_state, obs: torch.Tensor, h: torch.Tensor,
                   split: Optional[Dict[str, float]] = None):
        """One rollout + truncated-BPTT PPO update: ``(ts, env_state, obs, h,
        metrics)``; ``split`` as in ``PPOLearner.train_step``."""
        ts, (env_state, obs, h), metrics = self.eager.train(ts, (env_state, obs, h), split)
        return ts, env_state, obs, h, metrics

    def jit_train_step(self, mesh=None):
        """Not graphed yet (the JAX package's ``RecurrentPPOLearner`` jits
        its step): ``train_step`` runs eagerly, and ROADMAP queues the graph."""
        raise NotImplementedError("RecurrentPPOLearner has no graphed step yet; "
                                  "train_step runs it eagerly")
