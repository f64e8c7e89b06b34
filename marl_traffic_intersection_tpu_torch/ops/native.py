"""Builds the port's C++/CUDA sources at first use and loads them with ctypes.

Nothing is built ahead of time. Each source in ``csrc/`` becomes one shared
library with a plain C interface under the package's ``_build/`` directory
(listed in .gitignore), named by a digest of the sources and flags, so a
changed header rebuilds and an unchanged one is reused; the compiler's
output (ptxas's registers and spills for a .cu) is kept beside it:

  * ``*.cu``  -> nvcc for sm_90a (Hopper), contraction off, IEEE divide and
    sqrt: the kernels must round every product before its add, like the
    reference simulator does;
  * ``*.cpp`` -> g++ with ``-ffp-contract=off`` (the CPU side of ops/libm.py,
    and K1's ray body built for the CPU tests, csrc/lidar_host.cpp).

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()
BUILD_SECONDS: dict = {}      # source name -> seconds, for the builds of this process

_LIBS: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _compiler(source: str) -> list:
    if source.endswith(".cu"):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {source} needs the CUDA toolkit")
        return [nvcc, *NVCC_FLAGS]
    return [shutil.which("g++") or "g++", *GXX_FLAGS]


def library_path(source: str) -> pathlib.Path:
    """Where ``source``'s library lives: the name carries a digest of every
    file in csrc/ that it may include and of the compiler flags."""
    h = hashlib.sha256(" ".join(_compiler(source)[1:]).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def start_build(source: str):
    """Start compiling ``source`` unless its library exists. Returns
    ``(process, tmp_path, out_path, t0)`` or None; finish with ``finish_build``.
    Several builds started together compile in parallel."""
    out = library_path(source)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = _compiler(source) + [str(CSRC / source), "-o", str(tmp)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def finish_build(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    stdout, stderr = proc.communicate()
    BUILD_SECONDS[source] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed:\n{stdout}{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file


def build_log(source: str) -> str:
    """The compiler's output for ``source``'s library, built or not by this
    process."""
    return library_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        finish_build(source, start_build(source))
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launcher returned a nonzero cudaGetLastError()."""
    if rc != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
