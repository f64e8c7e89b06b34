"""The plain reference of the PPO learner's train step, after the rollout.

Given a trajectory (observations, the sampled pre-tanh actions, rewards and
done flags) and the action noise and minibatch permutations that the step
drew, ``Learner.step`` computes what the step computes from it:

  * the policy's mean, log-std and value at every observation, the sampled
    action ``raw = mean + exp(log_std) * noise``, the log-probability of the
    tanh-squashed Gaussian at the trajectory's action (the tanh correction
    ``2 (log 2 - u - softplus(-2u))`` with ``softplus(x) = log(exp(x) + 1)``
    as ``torch.logaddexp``, jax.nn.softplus's form), and the last value;
  * GAE, each operation rounded to float32 on its own, the bootstrap cut at
    episode ends and at each agent's done;
  * ``update_epochs`` epochs of ``num_minibatches`` minibatches, each a slice
    of one permutation of the time axis: the clipped loss with the
    advantages normalised by the minibatch's mean and population standard
    deviation, the value loss clipped, the entropy bonus; its gradient (by
    autograd of the forward written out here), clipped to a global norm as
    optax's ``clip_by_global_norm`` does (passed as is below the norm,
    scaled to it otherwise); Adam with bias corrections, in float32.

The dense layers run at the configuration's precision (policies/, whose
docstring gives that departure from all-float32), all else in float32;
TF32 is turned off for the run (``no_tf32``). The reference imports
nothing of the program and takes nothing it made but what it judges: it starts from the parameters
the benchmark drew, keeps its own parameters and Adam state through the
steps, and reads the trajectories, which are the env's data.

``variant`` puts a control or a planted fault in the program's place
(portbench/learner_control.py): ``bf16_master`` keeps the parameters and
Adam's moments in bfloat16, the precision below the stated float32;
``fp8_forward`` rounds the products' inputs and weights to float8 e4m3 (a
per-tensor scale, the largest magnitude to the format's largest finite
value), the precision below the stated bfloat16; ``half_batch`` takes each
minibatch's loss over the first half of its envs; ``minibatch_skipped``
skips the last minibatch of the step; ``perm_reused`` cuts every epoch from
the first epoch's permutation; ``adam_no_bias`` drops Adam's bias
corrections; ``adam_reset`` starts every step from a fresh Adam (moments
0, no step taken), as a program that dropped its optimizer's state between
calls would.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import torch
from torch.nn import functional as F


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float64).to(torch.float32))


LOG_2PI = _f32(math.log(2.0 * math.pi))
LOG_2 = _f32(math.log(2.0))
HALF_LOG_2PIE = _f32(0.5 * math.log(2.0 * math.pi * math.e))
FP8_MAX = 448.0             # float8 e4m3fn's largest finite value
VARIANTS = ("bf16_master", "fp8_forward", "half_batch", "minibatch_skipped", "perm_reused",
            "adam_no_bias", "adam_reset")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class Hyper:
    """The learner's hyperparameters, as a configuration's ``learner`` states them."""
    rollout_len: int
    update_epochs: int
    num_minibatches: int
    gamma: float
    gae_lambda: float
    clip_eps: float
    vf_coef: float
    ent_coef: float
    lr: float
    max_grad_norm: float
    adam_betas: tuple
    adam_eps: float


def no_tf32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def policy(family: str):
    """The plain reference of a policy family (policies/<family>.py)."""
    return importlib.import_module(f"{__package__}.policies.{family}")


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, as float32."""
    t = t.float()
    scale = FP8_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def product_at(dtype: torch.dtype, fp8: bool = False):
    """``product(x, w, b)``: a dense layer with its operands cast to ``dtype``."""
    def product(x, w, b):
        if fp8:
            x, w = round_fp8(x), round_fp8(w)
        return F.linear(x.to(dtype), w.to(dtype), b.to(dtype))
    return product


def logp_and_entropy(mean, log_std, raw):
    """The tanh-squashed Gaussian's log-probability at the pre-tanh ``raw``
    (summed over the action's dimensions) and the base Gaussian's entropy."""
    var = torch.exp(log_std) * torch.exp(log_std)
    logp = -0.5 * (((raw - mean) ** 2) / var + 2.0 * log_std + LOG_2PI).sum(-1)
    m2u = -2.0 * raw
    logp = logp - (2.0 * (LOG_2 - raw - torch.logaddexp(m2u, torch.zeros_like(m2u)))).sum(-1)
    entropy = (log_std + HALF_LOG_2PIE).sum(-1)
    return logp, entropy.expand(logp.shape)


def gae(reward, value, ep_done, agent_done, last_value, gamma: float, lam: float):
    """Advantages and returns (T, B, N) by GAE, backwards over the time axis."""
    done = (ep_done[..., None] | agent_done).float()
    advs = torch.empty_like(reward)
    acc = torch.zeros_like(last_value)
    after = last_value
    for t in reversed(range(reward.shape[0])):
        nonterm = 1.0 - done[t]
        delta = reward[t] + gamma * after * nonterm - value[t]
        acc = delta + gamma * lam * nonterm * acc
        advs[t] = acc
        after = value[t]
    return advs, advs + value


class Learner:
    """The reference learner: its own parameters and Adam state, stepped on
    the program's trajectories (see the module docstring)."""

    def __init__(self, family: str, kw: dict, params: dict, hyper: Hyper,
                 compute: str = "bfloat16", variant: str = None, adam: tuple = None):
        """``adam``: Adam's (first moments, second moments, steps taken) to
        start from; by default a fresh Adam."""
        if variant is not None and variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.pol, self.kw, self.h, self.variant = policy(family), kw, hyper, variant
        self.store = torch.bfloat16 if variant == "bf16_master" else torch.float32

        def held(tree):
            return {k: v.detach().to(self.store).clone() for k, v in tree.items()}
        self.params = held(params)
        if adam is None or variant == "adam_reset":
            self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.t = 0
        else:
            self.m, self.v, self.t = held(adam[0]), held(adam[1]), int(adam[2])
        self.product = product_at(DTYPES[compute], fp8=variant == "fp8_forward")

    def forward(self, params: dict, obs: torch.Tensor):
        return self.pol.forward(params, obs, self.product, self.kw)

    def _f32_params(self, grad: bool = False) -> dict:
        return {k: v.float().detach().requires_grad_(grad) for k, v in self.params.items()}

    @torch.no_grad()
    def act(self, obs, raw, last_obs, noise):
        """(raw actions sampled from ``noise``, values, log-probabilities at
        the trajectory's ``raw``, last value), one rollout step at a time."""
        p = self._f32_params()
        out = [torch.empty_like(raw), *(torch.empty(raw.shape[:-1], device=raw.device)
                                        for _ in range(2))]
        for t in range(obs.shape[0]):
            mean, log_std, value = self.forward(p, obs[t])
            out[0][t] = mean + torch.exp(log_std) * noise[t]
            out[1][t] = value
            out[2][t] = logp_and_entropy(mean, log_std, raw[t])[0]
        return (*out, self.forward(p, last_obs)[2])

    def loss(self, p: dict, batch):
        """The minibatch's clipped PPO loss, and its scale: the sum of its
        terms' magnitudes."""
        obs, raw, old_logp, adv, ret, old_value = batch
        if self.variant == "half_batch":
            half = obs.shape[1] // 2
            obs, raw, old_logp, adv, ret, old_value = (x[:, :half] for x in batch)
        h = self.h
        mean, log_std, value = self.forward(p, obs)
        logp, entropy = logp_and_entropy(mean, log_std, raw)
        ratio = torch.exp(logp - old_logp)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = -torch.minimum(ratio * adv_n,
                                 torch.clamp(ratio, 1.0 - h.clip_eps, 1.0 + h.clip_eps)
                                 * adv_n).mean()
        v_clip = old_value + torch.clamp(value - old_value, -h.clip_eps, h.clip_eps)
        v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
        ent = entropy.mean()
        scale = pg_loss.abs() + h.ent_coef * ent.abs() + h.vf_coef * v_loss
        return pg_loss - h.ent_coef * ent + h.vf_coef * v_loss, float(scale.detach())

    @torch.no_grad()
    def adam(self, grads: dict) -> None:
        """Clip ``grads`` to the global norm, then one Adam step."""
        h = self.h
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < h.max_grad_norm, torch.ones_like(norm),
                            h.max_grad_norm / norm)
        self.t += 1
        b1, b2 = h.adam_betas
        c1, c2 = (1.0, 1.0) if self.variant == "adam_no_bias" else \
            (1.0 - b1 ** self.t, 1.0 - b2 ** self.t)
        for k, g in grads.items():
            g = g * scale
            m = b1 * self.m[k].float() + (1.0 - b1) * g
            v = b2 * self.v[k].float() + (1.0 - b2) * g * g
            p = self.params[k].float() - h.lr * (m / c1) / (torch.sqrt(v / c2) + h.adam_eps)
            self.m[k], self.v[k], self.params[k] = (x.to(self.store) for x in (m, v, p))

    def step(self, traj: dict, noise: torch.Tensor, perms: list) -> dict:
        """One train step on ``traj`` (obs, raw, reward, ep_done, agent_done,
        last_obs), the rollout's ``noise`` (T, B, N, act_dim) and the epochs'
        ``perms``: the step's outputs (raw, value, logp, last_value, advs,
        rets, the mean loss over its minibatches and the mean of its scale),
        its parameters and Adam's state after it taken by ``result``."""
        h = self.h
        raw, value, logp, last_value = self.act(traj["obs"], traj["raw"], traj["last_obs"],
                                                noise)
        advs, rets = gae(traj["reward"], value, traj["ep_done"], traj["agent_done"],
                         last_value, h.gamma, h.gae_lambda)
        data = (traj["obs"], traj["raw"], logp, advs, rets, value)
        size = h.rollout_len // h.num_minibatches
        losses, scales = [], []
        for e in range(h.update_epochs):
            perm = perms[0 if self.variant == "perm_reused" else e]
            for i in range(h.num_minibatches):
                if self.variant == "minibatch_skipped" and e == h.update_epochs - 1 \
                        and i == h.num_minibatches - 1:
                    continue
                idx = perm[i * size:(i + 1) * size]
                p = self._f32_params(grad=True)
                loss, scale = self.loss(p, tuple(x[idx] for x in data))
                grads = torch.autograd.grad(loss, list(p.values()))
                self.adam(dict(zip(p, grads)))
                losses.append(float(loss.detach()))
                scales.append(scale)
        return {"raw": raw, "value": value, "logp": logp, "last_value": last_value,
                "advs": advs, "rets": rets, "loss": sum(losses) / len(losses),
                "scale": sum(scales) / len(scales)}

    def result(self) -> tuple:
        """(parameters, Adam's (first moments, second moments, steps taken)),
        float32 copies."""
        def f32(tree):
            return {k: v.float().clone() for k, v in tree.items()}
        return f32(self.params), (f32(self.m), f32(self.v), self.t)
