"""The plain reference of the ``mlp`` policy family: the flagship actor-critic
MLP, a tanh torso of ``hidden`` widths, a Gaussian mean head of ``act_dim``,
a value head, and a state-independent log-std bounded to [-4, 0.5] by a
tanh, as a function of its parameters, named as the program names them.

Every product runs through ``product(x, weight, bias)``, given by the
learner's reference (reference/ppo.py), which casts the operands to the
precision the configuration states and returns its result in it. The
departure from an all-float32 reference is that one: the configuration
states bfloat16 dense layers (inputs, weights and bias cast at the product,
as flax's ``nn.Dense(dtype=bfloat16)`` with float32 parameters), so the
torso's activations, and the tanh between the products, are bfloat16, as
they are there; a float32 forward would differ from any implementation of
that statement by far more than rounding. The heads' outputs are taken to
float32, and the log-std and all that follows are float32.
"""
from __future__ import annotations

import math

import torch

LOG_STD_LO, LOG_STD_HI = -4.0, 0.5


def _dims(kw: dict) -> list:
    return [int(kw.get("obs_dim", 127)), *(int(h) for h in kw.get("hidden", (256, 256)))]


def shapes(kw: dict) -> dict:
    """Each parameter's shape by name."""
    dims, act = _dims(kw), int(kw.get("act_dim", 2))
    out = {"log_std": (act,)}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"torso.{i}.weight"], out[f"torso.{i}.bias"] = (b, a), (b,)
    out.update({"pi_mean.weight": (act, dims[-1]), "pi_mean.bias": (act,),
                "vf.weight": (1, dims[-1]), "vf.bias": (1,)})
    return out


def init(kw: dict, generator: torch.Generator, device) -> dict:
    """Parameters drawn from ``generator`` in one call: each weight a normal
    of variance 1/fan_in (the mean head's 10^-4/fan_in, as small as a fresh
    policy's), each bias a normal of std 0.01, the log-std's raw value
    where the bounded log-std is 0 plus a normal of std 0.1."""
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
            x = x * ((0.01 if name.startswith("pi_mean") else 1.0) / math.sqrt(s[1]))
        out[name] = x.contiguous()
    return out


def forward(params: dict, obs: torch.Tensor, product, kw: dict):
    """obs (..., obs_dim) -> (mean (..., act_dim), log_std (act_dim,), value (...)),
    float32."""
    x = obs
    for i in range(len(_dims(kw)) - 1):
        x = torch.tanh(product(x, params[f"torso.{i}.weight"], params[f"torso.{i}.bias"]))
    mean = product(x, params["pi_mean.weight"], params["pi_mean.bias"]).float()
    value = product(x, params["vf.weight"], params["vf.bias"])[..., 0].float()
    raw = params["log_std"].float()
    log_std = LOG_STD_LO + 0.5 * (LOG_STD_HI - LOG_STD_LO) * (torch.tanh(raw) + 1.0)
    return mean, log_std, value


def flops_per_sample(kw: dict) -> int:
    """The forward's FLOPs per sample: two per multiply-add of each product."""
    dims, act = _dims(kw), int(kw.get("act_dim", 2))
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:])) + dims[-1] * (act + 1)
    return 2 * macs
