"""ctypes loader/wrapper for the native C++ host engine (csrc/engine.cpp).

Counterpart of marl_traffic_intersection_tpu/native/host.py. The engine is
host code by design: a caller picks it (``GymIntersectionEnv`` with
``backend="native"``) for interactive play, CPU-only deployment and
MCTS-style low-latency rollouts, where a per-step device round trip would
dominate; it is no fallback for the card, whose engine (core/) remains the
batch-scale path. csrc/engine.cpp is a byte-for-byte copy of the JAX
package's engine. It is built with g++ at first use, with the JAX package's
flags, into the package's ``_build/`` (listed in .gitignore), under a name
that carries a digest of the source and the flags.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import pathlib
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "engine.cpp"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_LIB = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _PKG / "_build" / f"libmti_native-{h}.so"


def _build() -> pathlib.Path:
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)    # atomic: a concurrent loader never sees half a file
    return out


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ct.CDLL(str(_build()))
    lib.mti_create.restype = ct.c_void_p
    lib.mti_create.argtypes = [ct.c_int]
    lib.mti_destroy.argtypes = [ct.c_void_p]
    lib.mti_configure.argtypes = [ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
                                  ct.c_int, ct.c_float, ct.c_int, ct.c_uint64]
    lib.mti_set_reward.argtypes = [ct.c_void_p, _f32p]
    lib.mti_reset.argtypes = [ct.c_void_p]
    lib.mti_add_ego.argtypes = [ct.c_void_p, ct.c_int]
    lib.mti_num_routes.restype = ct.c_int
    lib.mti_num_routes.argtypes = [ct.c_void_p]
    lib.mti_num_traffic_routes.restype = ct.c_int
    lib.mti_num_traffic_routes.argtypes = [ct.c_void_p]
    lib.mti_get_route_table.argtypes = [ct.c_void_p, _f32p]
    lib.mti_step.argtypes = [ct.c_void_p, _f32p, ct.c_float, ct.c_int, ct.c_int,
                             _f32p, _f32p, _i32p, _i32p, _i32p]
    lib.mti_step_count.restype = ct.c_int
    lib.mti_step_count.argtypes = [ct.c_void_p]
    lib.mti_get_egos.argtypes = [ct.c_void_p, _f32p]
    lib.mti_num_npcs.restype = ct.c_int
    lib.mti_num_npcs.argtypes = [ct.c_void_p]
    lib.mti_get_npcs.argtypes = [ct.c_void_p, _f32p]
    lib.mti_get_lidar.argtypes = [ct.c_void_p, ct.c_int, _f32p]
    lib.mti_get_obs.argtypes = [ct.c_void_p, _f32p]
    _LIB = lib
    return lib


class NativeEngine:
    """Single-instance native env with the same step/obs contract as the
    port's core. Spawn decisions: internal seeded RNG by default, or inject
    via the ``spawn`` argument of step() for lockstep testing."""

    def __init__(self, num_lanes: int = 3, use_team: bool = False,
                 respawn: bool = True, max_steps: int = 2000,
                 traffic: bool = False, density: float = 0.5,
                 max_npcs: int = 32, seed: int = 0,
                 reward: Optional[Sequence[float]] = None):
        self._lib = _load()
        self._h = self._lib.mti_create(num_lanes)
        self.num_lanes = num_lanes
        self._lib.mti_configure(self._h, int(use_team), int(respawn), max_steps,
                                int(traffic), density, max_npcs, seed)
        if reward is not None:
            self._lib.mti_set_reward(self._h, np.asarray(reward, np.float32))
        self.n = 0

    def __del__(self):
        try:
            self._lib.mti_destroy(self._h)
        except Exception:
            pass

    def reset(self, route_ids: Sequence[int]):
        self._lib.mti_reset(self._h)
        for rid in route_ids:
            self._lib.mti_add_ego(self._h, int(rid))
        self.n = len(route_ids)

    def observations(self) -> np.ndarray:
        """Current (N, 127) observation snapshot — used for the reset obs
        (reference: env.py:158 returns get_observations() after reset)."""
        obs = np.zeros((self.n, 127), np.float32)
        self._lib.mti_get_obs(self._h, obs)
        return obs

    def step(self, actions: np.ndarray, dt: float = 1.0 / 60.0,
             spawn: Optional[Tuple[bool, int]] = None):
        a = np.ascontiguousarray(np.asarray(actions, np.float32).reshape(self.n, 2))
        obs = np.zeros((self.n, 127), np.float32)
        rew = np.zeros((self.n,), np.float32)
        done = np.zeros((self.n,), np.int32)
        status = np.zeros((self.n,), np.int32)
        flags = np.zeros((4,), np.int32)
        if spawn is None:
            mode, route = -1, 0
        else:
            mode, route = (1, int(spawn[1])) if spawn[0] else (0, 0)
        self._lib.mti_step(self._h, a, dt, mode, route, obs, rew, done, status, flags)
        return dict(obs=obs, reward=rew, done=done, status=status,
                    terminated=bool(flags[0]), truncated=bool(flags[1]),
                    agents_alive=int(flags[2]), spawned=bool(flags[3]),
                    step=self._lib.mti_step_count(self._h))

    def egos(self) -> np.ndarray:
        out = np.zeros((self.n, 7), np.float32)
        self._lib.mti_get_egos(self._h, out)
        return out

    def npcs(self) -> np.ndarray:
        m = self._lib.mti_num_npcs(self._h)
        out = np.zeros((m, 6), np.float32)
        if m:
            self._lib.mti_get_npcs(self._h, out)
        return out

    def lidar(self, agent: int) -> np.ndarray:
        out = np.zeros((96,), np.float32)
        self._lib.mti_get_lidar(self._h, agent, out)
        return out

    def route_table(self) -> np.ndarray:
        r = self._lib.mti_num_routes(self._h)
        out = np.zeros((r, 160, 2), np.float32)
        self._lib.mti_get_route_table(self._h, out.reshape(-1))
        return out
