"""The plain reference of the ``central`` policy family: the centralised-critic
actor-critic (MAPPO's layout). The actor is the flagship per-agent tanh
MLP of ``hidden`` widths with a Gaussian mean head of ``act_dim`` and a
state-independent log-std bounded to [-4, 0.5] by a tanh; the critic embeds
each agent's observation (``embed`` wide, tanh), mean-pools the embeddings
over the agent axis (the observation's second last), and reads each
agent's value from [own embedding, pooled embedding] through a tanh layer
``2 * embed`` wide. Parameters are named as the program names them.

Every product runs through ``product(x, weight, bias)`` (reference/ppo.py's
``product_at``), which casts the operands to the precision the policy
states and returns its result in it: with bfloat16 dense layers the
torso's and the critic's activations are bfloat16, as flax's
``nn.Dense(dtype=bfloat16)`` makes them. The pooling sums in float32; the
heads' outputs are taken to float32, and all that follows is float32.

``load(path, kw)`` reads a shipped export (an ``.npz`` of float32 arrays
under flax's names, ``params/<layer>/kernel`` of shape (in, out) and
``params/<layer>/bias``) with numpy, and checks each shape against
``shapes(kw)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG_STD_LO, LOG_STD_HI = -4.0, 0.5
_HEADS = ("pi_mean", "critic_embed", "critic_joint", "vf")


def _dims(kw: dict) -> list:
    return [int(kw.get("obs_dim", 127)), *(int(h) for h in kw.get("hidden", (256, 256)))]


def shapes(kw: dict) -> dict:
    """Each parameter's shape by name."""
    dims, act = _dims(kw), int(kw.get("act_dim", 2))
    embed = int(kw.get("embed", 128))
    out = {"log_std": (act,)}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"torso.{i}.weight"], out[f"torso.{i}.bias"] = (b, a), (b,)
    for name, (a, b) in zip(_HEADS, ((dims[-1], act), (dims[0], embed),
                                     (2 * embed, 2 * embed), (2 * embed, 1))):
        out[f"{name}.weight"], out[f"{name}.bias"] = (b, a), (b,)
    return out


def init(kw: dict, generator: torch.Generator, device) -> dict:
    """Parameters drawn from ``generator`` in one call: each weight a normal
    of variance 1/fan_in, each bias a normal of std 0.01, the log-std's raw
    value where the bounded log-std is 0 plus a normal of std 0.1."""
    sh = shapes(kw)
    flat = torch.randn(sum(math.prod(s) for s in sh.values()), generator=generator,
                       device=device)
    raw0 = math.atanh(2.0 * (0.0 - LOG_STD_LO) / (LOG_STD_HI - LOG_STD_LO) - 1.0)
    out, at = {}, 0
    for name, s in sh.items():
        n = math.prod(s)
        x = flat[at:at + n].reshape(s)
        at += n
        if name == "log_std":
            x = raw0 + 0.1 * x
        elif name.endswith("bias"):
            x = 0.01 * x
        else:
            x = x / math.sqrt(s[1])
        out[name] = x.contiguous()
    return out


def load(path, kw: dict, device="cpu") -> dict:
    """The parameters of a shipped export at ``path`` (see the module
    docstring) by the program's names; ValueError where a leaf is missing or
    its shape is not ``shapes(kw)``'s."""
    want = shapes(kw)
    out = {}
    with np.load(path) as z:
        for name, shape in want.items():
            if name == "log_std":
                key, t = "params/log_std", False
            else:
                layer, leaf = name.rsplit(".", 1)
                key = "params/" + layer.replace(".", "_") + ("/kernel" if leaf == "weight"
                                                             else "/bias")
                t = leaf == "weight"
            if key not in z.files:
                raise ValueError(f"{path}: no leaf {key}")
            a = np.asarray(z[key], np.float32)
            a = a.T if t else a
            if tuple(a.shape) != tuple(shape):
                raise ValueError(f"{path}: {key} is {a.shape}, the policy states {shape}")
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def forward(params: dict, obs: torch.Tensor, product, kw: dict):
    """obs (..., N, obs_dim) -> (mean (..., N, act_dim), log_std (act_dim,),
    value (..., N)), float32."""
    a = obs
    for i in range(len(_dims(kw)) - 1):
        a = torch.tanh(product(a, params[f"torso.{i}.weight"], params[f"torso.{i}.bias"]))
    mean = product(a, params["pi_mean.weight"], params["pi_mean.bias"]).float()
    e = torch.tanh(product(obs, params["critic_embed.weight"], params["critic_embed.bias"]))
    pooled = e.float().sum(-2, keepdim=True) / e.shape[-2]
    joint = torch.cat([e.float(), pooled.expand(e.shape).float()], -1)
    c = torch.tanh(product(joint, params["critic_joint.weight"], params["critic_joint.bias"]))
    value = product(c, params["vf.weight"], params["vf.bias"])[..., 0].float()
    raw = params["log_std"].float()
    log_std = LOG_STD_LO + 0.5 * (LOG_STD_HI - LOG_STD_LO) * (torch.tanh(raw) + 1.0)
    return mean, log_std, value


def flops_per_sample(kw: dict) -> int:
    """The forward's FLOPs per agent, the critic's included: two per
    multiply-add of each product."""
    sh = shapes(kw)
    return 2 * sum(math.prod(s) for name, s in sh.items() if name.endswith("weight"))
