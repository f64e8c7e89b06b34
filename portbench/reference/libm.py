"""The reference's float32 transcendentals: the host's glibc, as the
reference simulator calls it.

Each function takes float32 tensors on any device and calls glibc's
``sinf``, ``cosf``, ``tanf``, ``atan2f`` or ``hypotf`` through ctypes, once
per distinct operand or operand pair (the broadcast views of the SAT test
repeat one heading many times), and returns the results on the operands'
device. Nothing is compiled. ``sqrtf`` is the float64 square root rounded
once to float32, which is the correctly rounded float32 root. ``div``
divides by a constant as an IEEE division: the constant goes in as a tensor,
since a division of a CUDA tensor by a Python scalar becomes a multiply by
its reciprocal.

``using(kind)`` swaps the transcendentals while its block runs, for the
benchmark's control (control.py): ``"torch"`` takes torch's own ``sin``,
``cos``, ``tan``, ``atan2`` and ``hypot``, which differ from glibc by an ulp
on some inputs.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import functools

import numpy as np
import torch

_KINDS = ("glibc", "torch")
_active = ["glibc"]


@contextlib.contextmanager
def using(kind: str):
    """Run the block with the transcendentals of ``kind`` (see the module
    docstring); the previous kind comes back after it."""
    if kind not in _KINDS:
        raise ValueError(f"libm kind {kind!r}: one of {_KINDS}")
    _active.append(kind)
    try:
        yield
    finally:
        _active.pop()


@functools.lru_cache(maxsize=None)
def _glibc(name: str, arity: int):
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = [ctypes.c_float] * arity, ctypes.c_float
    return fn


def _host(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """glibc's ``name`` over the broadcast float32 tensors ``xs`` (one or two)."""
    xs = torch.broadcast_tensors(*xs)
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {x.dtype}")
    shape, dev = xs[0].shape, xs[0].device
    bits = [x.detach().to("cpu").contiguous().numpy().reshape(-1).view(np.uint32) for x in xs]
    key = bits[0].astype(np.uint64)
    if len(bits) == 2:
        key = (key << np.uint64(32)) | bits[1]
    uniq, inv = np.unique(key, return_inverse=True)
    cols = [(uniq >> np.uint64(32)).astype(np.uint32), uniq.astype(np.uint32)] \
        if len(bits) == 2 else [uniq.astype(np.uint32)]
    args = [c.view(np.float32).tolist() for c in cols]
    vals = np.fromiter(map(_glibc(name, len(bits)), *args), np.float32, count=uniq.size)
    return torch.from_numpy(vals[inv.reshape(-1)].reshape(shape)).to(dev)


def sincosf(x: torch.Tensor) -> tuple:
    """``(sinf(x), cosf(x))``."""
    if _active[-1] == "torch":
        return torch.sin(x), torch.cos(x)
    return _host("sinf", x), _host("cosf", x)


def tanf(x: torch.Tensor) -> torch.Tensor:
    return torch.tan(x) if _active[-1] == "torch" else _host("tanf", x)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y, x) if _active[-1] == "torch" else _host("atan2f", y, x)


def hypotf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.hypot(x, y) if _active[-1] == "torch" else _host("hypotf", x, y)


def atan2f_diff(ay, by, ax, bx) -> torch.Tensor:
    """``atan2f(-(ay - by), ax - bx)``, the differences in float32."""
    return atan2f(-(ay - by), ax - bx)


def hypotf_diff(ax, bx, ay, by) -> torch.Tensor:
    """``hypotf(ax - bx, ay - by)``, the differences in float32."""
    return hypotf(ax - bx, ay - by)


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


@functools.lru_cache(maxsize=1024)
def _const(value: float, device: str) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=device)


def const(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor holding ``np.float32(value)`` on ``device``."""
    return _const(float(np.float32(value)), str(device))


_TABLES: dict = {}


def table(values: np.ndarray, device) -> torch.Tensor:
    """``values`` (a module-level array) on ``device``, copied there once."""
    key = (id(values), str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(values).to(device)
    return _TABLES[key]


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE float32 ``a / c`` for a constant ``c``."""
    return a / const(c, a.device)


def glibc_np(name: str, *arrays) -> np.ndarray:
    """glibc's ``name`` (sinf, cosf, atan2f) on float32 numpy arrays."""
    shape = np.broadcast_shapes(*(np.shape(a) for a in arrays))
    xs = [torch.from_numpy(np.array(np.broadcast_to(np.asarray(a, np.float32), shape)))
          for a in arrays]
    return _host(name, *xs).numpy()
