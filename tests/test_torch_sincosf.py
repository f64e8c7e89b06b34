"""ops/libm.py's ``sincosf`` and the redesigned ``tanf`` on the CPU.

``libm.sincosf`` is bit-equal to ``(libm.sinf, libm.cosf)`` and to the JAX
package's ``jnp.sin``/``jnp.cos``; ``transcribed_np("sincosf")`` (the
header's ``sincosf`` built for the CPU, which the card's kernel runs) is
bit-equal to the header's ``sinf``/``cosf`` and to glibc; the header's
``tanf`` (one path per lane, one division) is bit-equal to glibc, on the
steering angles, around its 0.6744 switch and around the odd multiples of
pi/4. The env's call sites take the sine and cosine of an angle together.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
from marl_traffic_intersection_tpu_torch.core.constants import MAX_STEERING_ANGLE
from marl_traffic_intersection_tpu_torch.ops import libm

from . import _torch_port  # noqa: F401  (one torch thread per test worker)


def _around(value, width):
    """Every float32 within ``width`` ulps of ``value``, and of ``-value``."""
    bits = np.asarray([value], np.float32).view(np.int32)[0]
    x = (np.arange(-width, width + 1, dtype=np.int32) + bits).view(np.float32)
    return np.concatenate([x, -x])


EDGES = np.concatenate([
    np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40, 1e-45, -1e-45,
                np.finfo(np.float32).tiny, 3e38, -3e38], np.float32),
    _around(2.0 ** -12, 4), _around(np.pi / 4, 4), _around(120.0, 4)])


def _inputs(kind, n=200_000):
    rng = np.random.RandomState({"uniform": 0, "heading": 1, "edges": 2}[kind])
    lo = {"uniform": 7.0, "heading": 2 * np.pi, "edges": 1.0}[kind]
    x = rng.uniform(-lo, lo, n).astype(np.float32)
    if kind == "edges":   # every binade below 120, subnormals too, both signs
        top = int(np.asarray([120.0], np.float32).view(np.int32)[0])
        x = (rng.randint(0, top, n, dtype=np.int64).astype(np.int32)
             | np.where(rng.rand(n) < 0.5, np.int32(-2 ** 31), np.int32(0))).view(np.float32)
    return np.concatenate([x, EDGES])


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "heading", "edges"])
def test_cpu_sincosf_is_sinf_cosf_and_jax(kind):
    x = _inputs(kind)
    s, c = (t.numpy() for t in libm.sincosf(torch.from_numpy(x)))
    xt = torch.from_numpy(x)
    for got, want in ((s, libm.sinf(xt)), (c, libm.cosf(xt)),
                      (s, jax.jit(jnp.sin)(x)), (c, jax.jit(jnp.cos)(x))):
        assert (_bits(got) == _bits(want)).all(), f"{(_bits(got) != _bits(want)).sum()} differ"
    assert _bits(s[x.view(np.int32) == np.int32(-2 ** 31)]).tolist() == [-2 ** 31]  # sin(-0) = -0


@pytest.mark.parametrize("kind", ["uniform", "heading", "edges"])
def test_transcribed_sincosf_is_the_header_pair_and_glibc(kind):
    x = _inputs(kind)
    s, c = libm.transcribed_np("sincosf", x)
    gs, gc = libm.glibc_np("sincosf", x)
    for got, want in ((s, libm.transcribed_np("sinf", x)), (c, libm.transcribed_np("cosf", x)),
                      (s, gs), (c, gc), (gs, libm.glibc_np("sinf", x)),
                      (gc, libm.glibc_np("cosf", x))):
        assert (_bits(got) == _bits(want)).all(), f"{(_bits(got) != _bits(want)).sum()} differ"


def _tan_inputs(kind):
    rng = np.random.RandomState(3)
    if kind == "steering":       # what car_physics_step passes
        x = rng.uniform(-MAX_STEERING_ANGLE, MAX_STEERING_ANGLE, 200_000)
    elif kind == "switch":       # kernel_tanf's |x| >= 0.6744 transform
        return np.concatenate([_around(0.6744, 100_000), EDGES])
    elif kind == "odd pi/4":     # reduced arguments near +-pi/4 and tiny ones
        x = np.concatenate([(2 * k + 1) * np.pi / 4 + rng.uniform(-1e-3, 1e-3, 1000)
                            for k in range(-76, 76)])
        x = np.concatenate([x, np.concatenate([_around(k * np.pi / 2, 200)
                                               for k in range(1, 76)])])
    else:
        x = _inputs(kind)
    return np.concatenate([np.asarray(x, np.float32), EDGES])


@pytest.mark.parametrize("kind", ["uniform", "edges", "steering", "switch", "odd pi/4"])
def test_transcribed_tanf_is_glibc(kind):
    x = _tan_inputs(kind)
    a, b = _bits(libm.transcribed_np("tanf", x)), _bits(libm.glibc_np("tanf", x))
    assert (a == b).all(), f"{(a != b).sum()} of {a.size} differ, first at {x[a != b][:5]}"


def test_sincosf_takes_a_broadcast_operand():
    """sat_overlap passes views of torch.broadcast_tensors."""
    h = torch.from_numpy(np.random.RandomState(4).uniform(-7, 7, (16, 1, 3)).astype(np.float32))
    view = h.expand(16, 5, 3)
    assert not view.is_contiguous()
    for got, want in zip(libm.sincosf(view), libm.sincosf(view.contiguous())):
        assert got.shape == (16, 5, 3) and torch.equal(got.view(torch.int32),
                                                       want.view(torch.int32))


@pytest.mark.parametrize("traffic", [False, True])
def test_env_step_takes_sine_and_cosine_together(monkeypatch, traffic):
    """Every sine the step and observation take comes with its cosine in one
    ``sincosf`` call: no ``sinf`` or ``cosf`` alone (on the card, no two
    launches for one angle)."""
    calls = []
    apply = libm._apply
    monkeypatch.setattr(libm, "_apply", lambda name, *xs: calls.append(name) or apply(name, *xs))
    cfg = EnvConfig(num_agents=2, traffic_flow=traffic, traffic_density=3.0, max_npcs=8)
    venv = VectorEnv(IntersectionEnv(cfg, device="cpu"), num_envs=4, seed=0)
    state, _ = venv.reset()
    for _ in range(3):
        state, _ = venv.step(state, torch.full((4, 2, 2), 0.5))
    assert "sincosf" in calls and not {"sinf", "cosf"} & set(calls), sorted(set(calls))
