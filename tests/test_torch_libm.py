"""ops/libm.py against the JAX package and glibc.

The port's CPU libm (the host glibc through its shim) is bit-equal to the
JAX package's host shim (ops/libm_host.py) and to ``jax.jit(jnp.sin)`` &
co.; csrc/libm_f32.cuh, the transcription the CUDA kernels run, built for
the CPU with g++ -ffp-contract=off, is bit-equal to the host glibc.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.ops import libm_host
from marl_traffic_intersection_tpu_torch.ops import libm

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

AXIS = np.asarray([0.0, -0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 2 * np.pi,
                   -2 * np.pi, np.pi / 4, 3 * np.pi / 4, 1e-5, -1e-5, 1e-30], np.float32)


def _inputs(seed, n=200_000):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-7, 7, n).astype(np.float32), AXIS])


def _eq(a, b):
    return np.asarray(a).view(np.int32), np.asarray(b).view(np.int32)


@pytest.mark.parametrize("name,jfn,hfn", [("sinf", jnp.sin, libm_host.sinf_np),
                                           ("cosf", jnp.cos, libm_host.cosf_np),
                                           ("tanf", jnp.tan, libm_host.tanf_np)])
def test_cpu_unary_matches_jax_and_host_shim(name, jfn, hfn):
    x = _inputs(0)
    got = getattr(libm, name)(torch.from_numpy(x)).numpy()
    a, b = _eq(got, hfn(x))
    assert (a == b).all()
    a, b = _eq(got, jax.jit(jfn)(x))
    assert (a == b).all()


def test_cpu_atan2_matches_jax_and_host_shim():
    y, x = _inputs(1), _inputs(2)
    x[:len(AXIS)] = AXIS[::-1]
    got = libm.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    a, b = _eq(got, libm_host.atan2f_np(y, x))
    assert (a == b).all()
    a, b = _eq(got, jax.jit(jnp.arctan2)(y, x))
    assert (a == b).all()


def test_cpu_hypot_is_glibc():
    """glibc 2.36 hypotf is float(sqrt(double(x)*x + double(y)*y))."""
    y, x = _inputs(3) * 100, _inputs(4) * 100
    got = libm.hypotf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    a, b = _eq(got, np.sqrt(xd * xd + yd * yd).astype(np.float32))
    assert (a == b).all()


@pytest.mark.parametrize("name", ["sinf", "cosf", "tanf", "atan2f", "hypotf"])
def test_transcription_built_for_cpu_matches_glibc(name):
    x = np.concatenate([_inputs(5), np.random.RandomState(6).uniform(-119, 119, 50_000)
                        .astype(np.float32)])
    args = (x,) if name in ("sinf", "cosf", "tanf") else (_inputs(7, len(x) - len(AXIS)), x)
    a, b = _eq(libm.transcribed_np(name, *args), libm.glibc_np(name, *args))
    assert (a == b).all(), f"{(a != b).sum()} of {a.size} differ"


def test_transcription_special_values():
    v = np.asarray([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-40, 3e38], np.float32)
    y, x = (a.ravel() for a in np.meshgrid(v, v))
    for name in ("atan2f", "hypotf"):
        a, b = _eq(libm.transcribed_np(name, y, x), libm.glibc_np(name, y, x))
        assert (a == b).all(), name


def test_sqrtf_is_correctly_rounded_and_div_is_ieee():
    x = np.random.RandomState(8).uniform(0, 1e6, 200_000).astype(np.float32)
    a, b = _eq(libm.sqrtf(torch.from_numpy(x)).numpy(), np.sqrt(x))
    assert (a == b).all()
    for c in (54.0, 750.0, float(np.float32(np.pi)), 0.6108652381980153):
        a, b = _eq(libm.div(torch.from_numpy(x), c).numpy(), x / np.float32(c))
        assert (a == b).all(), c


def test_libm_rejects_other_dtypes():
    with pytest.raises(TypeError):
        libm.sinf(torch.zeros(3, dtype=torch.float64))
