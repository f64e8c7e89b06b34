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

``atan2f_diff(ay, by, ax, bx)`` is ``atan2f(-(ay - by), ax - bx)`` (the
heading toward a point with the screen's y axis down) and
``hypotf_diff(ax, bx, ay, by)`` is ``hypotf(ax - bx, ay - by)``: the port's
call sites pass differences, and on the card each is one launch that
subtracts in f32 itself, bit-equal to the composition (on the CPU, that
composition: torch's subtractions, then the host glibc). They read their
operands on the card by strides, broadcast or interleaved views included,
with no contiguous copy. They are the card's only atan2f and hypotf
kernels: ``atan2f(y, x)`` launches ``atan2f_diff(-0.0, y, x, 0.0)`` and
``hypotf(x, y)`` ``hypotf_diff(x, 0.0, y, 0.0)`` (``-(-0.0 - y)`` is ``y``
and ``x - 0.0`` is ``x``, signed zeros included), counted as the diff
kernel's launches.

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
ARITY = {"sinf": (1, 1), "cosf": (1, 1), "tanf": (1, 1), "sincosf": (1, 2), "atanf": (1, 1),
         "atan2f": (2, 1), "hypotf": (2, 1), "atan2f_diff": (4, 1), "hypotf_diff": (4, 1)}
CUDA_KERNELS = ("sincosf", "tanf", "atan2f_diff", "hypotf_diff")
# the diff forms, whose kernels read their operands by strides (the other
# kernels take contiguous ones); on the CPU, the two-operand function and its
# operands
DIFF = {"atan2f_diff": ("atan2f", lambda ay, by, ax, bx: (-(ay - by), ax - bx)),
        "hypotf_diff": ("hypotf", lambda ax, bx, ay, by: (ax - bx, ay - by))}
# the two-operand functions on the card: the diff kernel that launches them
KERNEL_OF = {"atan2f": "atan2f_diff", "hypotf": "hypotf_diff"}
_SIGNED_ZEROS = np.asarray([-0.0, 0.0], np.float32)
MAX_DIMS = 4      # of a strided launch, after merging (csrc/libm.cu kDims)


def _pointers(name: str) -> list:
    return [ctypes.c_void_p] * sum(ARITY[name])


def _host() -> ctypes.CDLL:
    lib = native.load("libm_host.cpp")
    if not getattr(lib, "_typed", False):
        for pre in ("glibc_", "f32_"):
            for name in ARITY:
                fn = getattr(lib, pre + name)
                fn.argtypes, fn.restype = _pointers(name) + [ctypes.c_long], None
        lib.f64_sqrt_normal.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib._typed = True
    return lib


def type_cuda(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a build of csrc/libm.cu its launchers' argument types."""
    if not getattr(lib, "_typed", False):
        for name in CUDA_KERNELS:
            fn = getattr(lib, "libm_" + name)
            geom = [ctypes.POINTER(ctypes.c_long), ctypes.c_int] if name in DIFF else []
            fn.argtypes = _pointers(name) + geom + [ctypes.c_long, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _cuda() -> ctypes.CDLL:
    return type_cuda(native.load("libm.cu"))


def geometry(xs) -> tuple:
    """The shape of the broadcast operands ``xs`` with the dimensions of size
    1 dropped and every pair of neighbours that is contiguous in each operand
    merged: ``(sizes, strides)``, strides per operand in elements (0 where an
    operand is broadcast)."""
    xs = torch.broadcast_tensors(*xs)
    sizes, strides = [], []              # strides: per dimension, per operand
    for d, n in enumerate(xs[0].shape):
        if n == 1:
            continue
        st = [x.stride(d) for x in xs]
        if sizes and all(p == s * n for p, s in zip(strides[-1], st)):
            sizes[-1] *= n
            strides[-1] = st
        else:
            sizes.append(n)
            strides.append(st)
    if not sizes:
        return [1], [[0] for _ in xs]
    return sizes, [list(s) for s in zip(*strides)]


def launch(lib: ctypes.CDLL, name: str, xs) -> list:
    """Launch ``name`` (a kernel, or a function of KERNEL_OF) of the
    csrc/libm.cu build ``lib`` on the float32 CUDA tensors ``xs`` (any
    broadcast views for a diff kernel): its outputs."""
    if name in KERNEL_OF:
        nz, z = table(_SIGNED_ZEROS, xs[0].device)
        xs = (nz, xs[0], xs[1], z) if name == "atan2f" else (xs[0], z, xs[1], z)
        name = KERNEL_OF[name]
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    n = shape.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} elements, the kernels index below 2^31")
    if name in DIFF:
        sizes, strides = geometry(xs)
        if len(sizes) > MAX_DIMS or max(sum((n - 1) * s for n, s in zip(sizes, st))
                                        for st in strides) >= 2 ** 31:
            # not on the port's paths: contiguous copies, read in 1-D
            xs = [x.contiguous() for x in torch.broadcast_tensors(*xs)]
            sizes, strides = geometry(xs)
        geom = (ctypes.c_long * (len(sizes) * (1 + len(xs))))(
            *sizes, *(s for st in strides for s in st))
        args = [geom, len(sizes)]
    else:
        xs = [x.contiguous() for x in xs]
        args = []
    outs = [torch.empty(shape, dtype=torch.float32, device=xs[0].device)
            for _ in range(ARITY[name][1])]
    rc = getattr(lib, "libm_" + name)(*map(native.ptr, [*xs, *outs]), *args, n,
                                      native.stream_of(outs[0]))
    native.check(rc, lib, name)
    return outs


def _apply(name: str, *xs: torch.Tensor):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {x.dtype}")
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on different devices")
    if dev.type == "cpu":
        fn = name
        if name in DIFF:
            fn, form = DIFF[name]
            xs = form(*xs)
        xs = [x.contiguous() for x in torch.broadcast_tensors(*xs)]
        outs = [torch.empty_like(xs[0]) for _ in range(ARITY[name][1])]
        getattr(_host(), "glibc_" + fn)(*map(native.ptr, xs + outs), outs[0].numel())
    elif dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    else:
        outs = launch(_cuda(), name, xs)
        native.LAUNCHES[KERNEL_OF.get(name, name)] += 1
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


def atan2f_diff(ay: torch.Tensor, by: torch.Tensor, ax: torch.Tensor,
                bx: torch.Tensor) -> torch.Tensor:
    """``atan2f(-(ay - by), ax - bx)``, bit for bit (the difference negated,
    not swapped: ``-(a - a)`` is -0.0); one launch on the card."""
    return _apply("atan2f_diff", ay, by, ax, bx)


def hypotf_diff(ax: torch.Tensor, bx: torch.Tensor, ay: torch.Tensor,
                by: torch.Tensor) -> torch.Tensor:
    """``hypotf(ax - bx, ay - by)``, bit for bit; one launch on the card."""
    return _apply("hypotf_diff", ax, bx, ay, by)


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
    """The host glibc's ``name`` (a key of ARITY) on numpy; sincosf gives the
    pair."""
    return _np_call("glibc_", name, *arrays)


def transcribed_np(name: str, *arrays):
    """libm_f32.cuh's ``name`` built for the CPU, on numpy arrays."""
    return _np_call("f32_", name, *arrays)


def sqrt_normal_np(s: np.ndarray) -> np.ndarray:
    """The header's square root for hypotf (``sqrt_normal``), built for the
    CPU, on positive normal float64 values."""
    s = np.ascontiguousarray(s, np.float64)
    out = np.empty_like(s)
    _host().f64_sqrt_normal(ctypes.c_void_p(s.ctypes.data), ctypes.c_void_p(out.ctypes.data),
                            s.size)
    return out


# ---- the exhaustive host check of the header ------------------------------

def _mismatches(name: str, *arrays) -> int:
    a, b = transcribed_np(name, *arrays), glibc_np(name, *arrays)
    return int((a.view(np.int32) != b.view(np.int32)).sum())


def exhaustive(chunk_bits: int = 24, grid_bits: int = 15) -> dict:
    """The header built for the CPU against the host glibc: ``atanf`` on every
    float32; ``atan2f(y, 1.0f)`` on every float32 y (the x == 1.0f shortcut
    the header does not take); ``atan2f`` and ``hypotf`` on the grid of
    2^grid_bits x 2^grid_bits pairs whose bit patterns are k * 2^(32 -
    grid_bits) + 0x5555 (every exponent and both signs, NaNs and infinities
    included), both orders. Returns {check: (values or pairs, mismatches)}."""
    out = {}
    every = np.arange(1 << chunk_bits, dtype=np.uint32)
    for name, make in (("atanf", lambda x: (x,)),
                       ("atan2f(y, 1.0f)", lambda x: (x, np.float32(1.0)))):
        fn = name.split("(")[0]
        bad = sum(_mismatches(fn, *make((every + np.uint32(c << chunk_bits)).view(np.float32)))
                  for c in range(1 << (32 - chunk_bits)))
        out[name] = (1 << 32, bad)
    grid = ((np.arange(1 << grid_bits, dtype=np.uint64) << np.uint64(32 - grid_bits))
            + np.uint64(0x5555)).astype(np.uint32).view(np.float32)
    for name in ("atan2f", "hypotf"):
        bad = sum(_mismatches(name, np.full_like(grid, y), grid) for y in grid)
        out[f"{name} grid"] = (grid.size ** 2, bad)
    return out


if __name__ == "__main__":
    import json
    import os
    import sys
    import time

    t0 = time.perf_counter()
    res = exhaustive(*map(int, sys.argv[1:]))
    print(json.dumps({"checks": {k: {"inputs": n, "mismatches": b} for k, (n, b) in res.items()},
                      "glibc": os.confstr("CS_GNU_LIBC_VERSION"),
                      "seconds": round(time.perf_counter() - t0, 1)}))
    sys.exit(1 if any(b for _, b in res.values()) else 0)
