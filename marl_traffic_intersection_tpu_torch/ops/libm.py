"""glibc-faithful f32 math for every transcendental the port evaluates.

The reference simulator calls glibc's float ``sinf``/``cosf``/``tanf``/
``atan2f``/``hypotf``. PyTorch's own ``torch.sin`` & co. differ from glibc by
an ulp on a few percent of inputs, on the CPU and on the card, and one ulp in
a pose or a ray direction flips lidar pixels. So the port never calls them:

  * a CPU tensor goes through the host's glibc itself, by a small g++-built
    shim (csrc/libm_host.cpp, ``glibc_*``);
  * a CUDA tensor goes through the elementwise kernels of csrc/libm.cu,
    which run csrc/libm_f32.cuh, a transcription of glibc 2.36's algorithms
    (``f32_*`` in the same shim is that transcription built for the CPU, so
    it can be held against glibc without a card).

``sqrtf`` is ``sqrt`` in f64 rounded once to f32, which is the correctly
rounded f32 square root; f32 ``torch.sqrt`` on the CPU is not correctly
rounded (AVX-512 dispatch).

``div`` divides by a constant as an IEEE division: PyTorch turns a division
of a CUDA tensor by a Python scalar into a multiply by the reciprocal, so the
constant goes in as a tensor on the operand's device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native

_UNARY = ("sinf", "cosf", "tanf")
_BINARY = ("atan2f", "hypotf")


def _host() -> ctypes.CDLL:
    lib = native.load("libm_host.cpp")
    if not getattr(lib, "_typed", False):
        p, n = ctypes.c_void_p, ctypes.c_long
        for pre in ("glibc_", "f32_"):
            for name in _UNARY + _BINARY:
                fn = getattr(lib, pre + name)
                fn.argtypes = [p, p, n] if name in _UNARY else [p, p, p, n]
                fn.restype = None
        lib._typed = True
    return lib


def _cuda() -> ctypes.CDLL:
    lib = native.load("libm.cu")
    if not getattr(lib, "_typed", False):
        p, n = ctypes.c_void_p, ctypes.c_long
        for name in _UNARY:
            fn = getattr(lib, "libm_" + name)
            fn.argtypes, fn.restype = [p, p, n, p], ctypes.c_int
        for name in _BINARY:
            fn = getattr(lib, "libm_" + name)
            fn.argtypes, fn.restype = [p, p, p, n, p], ctypes.c_int
        lib._typed = True
    return lib


def _apply(name: str, *xs: torch.Tensor) -> torch.Tensor:
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {x.dtype}")
    if len(xs) == 2:
        xs = torch.broadcast_tensors(*xs)
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on different devices")
    xs = [x.contiguous() for x in xs]
    out = torch.empty_like(xs[0])
    n = out.numel()
    if dev.type == "cpu":
        getattr(_host(), "glibc_" + name)(*map(native.ptr, xs), native.ptr(out), n)
        return out
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    lib = _cuda()
    rc = getattr(lib, "libm_" + name)(*map(native.ptr, xs), native.ptr(out), n,
                                      native.stream_of(out))
    native.check(rc, lib, name)
    native.LAUNCHES[name] += 1
    return out


def sinf(x: torch.Tensor) -> torch.Tensor:
    return _apply("sinf", x)


def cosf(x: torch.Tensor) -> torch.Tensor:
    return _apply("cosf", x)


def tanf(x: torch.Tensor) -> torch.Tensor:
    return _apply("tanf", x)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _apply("atan2f", y, x)


def hypotf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _apply("hypotf", x, y)


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on either device."""
    return torch.sqrt(x.double()).float()


_ON_DEVICE: dict = {}


def const(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor holding ``np.float32(value)`` on ``device``."""
    key = ("const", float(np.float32(value)), str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.tensor(np.float32(value), device=device)
    return _ON_DEVICE[key]


def table(values: np.ndarray, device) -> torch.Tensor:
    """``values`` (a module-level array) on ``device``, copied there once."""
    key = ("table", id(values), str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(values).to(device)
    return _ON_DEVICE[key]


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE f32 ``a / c`` for a constant ``c`` (see the module docstring)."""
    return a / const(c, a.device)


# ---- numpy front ends (host-side table building, tests, chip_smoke) -------

def _np_call(prefix: str, name: str, *arrays) -> np.ndarray:
    shape = np.broadcast_shapes(*(np.shape(a) for a in arrays))
    xs = [np.ascontiguousarray(np.broadcast_to(np.asarray(a, np.float32), shape))
          for a in arrays]
    out = np.empty(shape, np.float32)
    lib = _host()
    args = [ctypes.c_void_p(a.ctypes.data) for a in xs + [out]]
    getattr(lib, prefix + name)(*args, out.size)
    return out


def glibc_np(name: str, *arrays) -> np.ndarray:
    """The host glibc's ``name`` (sinf, cosf, tanf, atan2f, hypotf) on numpy."""
    return _np_call("glibc_", name, *arrays)


def transcribed_np(name: str, *arrays) -> np.ndarray:
    """libm_f32.cuh's ``name`` built for the CPU, on numpy arrays."""
    return _np_call("f32_", name, *arrays)
