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

``sincosf`` gives ``(sinf(x), cosf(x))``: on the card one launch of one
kernel for the pair (``LAUNCHES["sincosf"]``), bit-equal to the two
functions. The port always wants both of an angle, so it calls ``sincosf``;
``sinf`` and ``cosf`` on the card are one ``sincosf`` launch each, the other
half dropped.

``sqrtf`` is ``sqrt`` in f64 rounded once to f32, which is the correctly
rounded f32 square root; f32 ``torch.sqrt`` on the CPU is not correctly
rounded (AVX-512 dispatch).

``div`` divides by a constant as an IEEE division: PyTorch turns a division
of a CUDA tensor by a Python scalar into a multiply by the reciprocal, so the
constant goes in as a tensor on the operand's device.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import native

# name: (operands, results); the CUDA side has only CUDA_KERNELS
ARITY = {"sinf": (1, 1), "cosf": (1, 1), "tanf": (1, 1), "sincosf": (1, 2),
         "atan2f": (2, 1), "hypotf": (2, 1)}
CUDA_KERNELS = ("sincosf", "tanf", "atan2f", "hypotf")


def _pointers(name: str) -> list:
    return [ctypes.c_void_p] * sum(ARITY[name])


def _host() -> ctypes.CDLL:
    lib = native.load("libm_host.cpp")
    if not getattr(lib, "_typed", False):
        for pre in ("glibc_", "f32_"):
            for name in ARITY:
                fn = getattr(lib, pre + name)
                fn.argtypes, fn.restype = _pointers(name) + [ctypes.c_long], None
        lib._typed = True
    return lib


def _cuda() -> ctypes.CDLL:
    lib = native.load("libm.cu")
    if not getattr(lib, "_typed", False):
        for name in CUDA_KERNELS:
            fn = getattr(lib, "libm_" + name)
            fn.argtypes = _pointers(name) + [ctypes.c_long, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _apply(name: str, *xs: torch.Tensor):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {x.dtype}")
    if len(xs) == 2:
        xs = torch.broadcast_tensors(*xs)
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on different devices")
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(xs[0]) for _ in range(ARITY[name][1])]
    args = [*map(native.ptr, xs + outs), outs[0].numel()]
    if dev.type == "cpu":
        getattr(_host(), "glibc_" + name)(*args)
    elif dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    else:
        lib = _cuda()
        native.check(getattr(lib, "libm_" + name)(*args, native.stream_of(outs[0])), lib, name)
        native.LAUNCHES[name] += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def sincosf(x: torch.Tensor) -> tuple:
    """``(sinf(x), cosf(x))``, bit-equal to the two calls; one launch on the
    card."""
    return _apply("sincosf", x)


def sinf(x: torch.Tensor) -> torch.Tensor:
    return _apply("sinf", x) if x.device.type == "cpu" else sincosf(x)[0]


def cosf(x: torch.Tensor) -> torch.Tensor:
    return _apply("cosf", x) if x.device.type == "cpu" else sincosf(x)[1]


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


@functools.lru_cache(maxsize=1024)
def _const(value: float, device: str) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=device)


def const(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor holding ``np.float32(value)`` on ``device``,
    made once; the last 1024 values are kept (a real-time loop's step
    lengths vary without end)."""
    return _const(float(np.float32(value)), str(device))


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

def _np_call(prefix: str, name: str, *arrays):
    shape = np.broadcast_shapes(*(np.shape(a) for a in arrays))
    xs = [np.ascontiguousarray(np.broadcast_to(np.asarray(a, np.float32), shape))
          for a in arrays]
    outs = [np.empty(shape, np.float32) for _ in range(ARITY[name][1])]
    lib = _host()
    args = [ctypes.c_void_p(a.ctypes.data) for a in xs + outs]
    getattr(lib, prefix + name)(*args, outs[0].size)
    return outs[0] if len(outs) == 1 else tuple(outs)


def glibc_np(name: str, *arrays):
    """The host glibc's ``name`` (sinf, cosf, tanf, sincosf, atan2f, hypotf)
    on numpy; sincosf gives the pair."""
    return _np_call("glibc_", name, *arrays)


def transcribed_np(name: str, *arrays):
    """libm_f32.cuh's ``name`` built for the CPU, on numpy arrays."""
    return _np_call("f32_", name, *arrays)
