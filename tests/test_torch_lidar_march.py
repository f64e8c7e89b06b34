"""K1's ray body (csrc/lidar_march.cuh), built for the CPU through
csrc/lidar_host.cpp, against the plain version core/lidar.py::lidar_scan_ref,
bit for bit.

The header is the algorithm the card runs, exact per-ray obstacle cull
included; the card itself is held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py. Inputs: the fuzz generators of
tests/test_lidar_fuzz.py (random, axis-aligned and integer-lattice poses with
36 obstacle slots; env batches of 1, 4 and 8 agents), batches of up to 64
obstacles, and the NaN, inf, -0.0 and screen-edge poses of
ops/lidar_cases.py. The cull rests on the sample sequence being monotone in k,
which the last test checks.
"""
import ctypes

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core.lidar import REL_ANGLES, lidar_scan_ref
from marl_traffic_intersection_tpu_torch.ops import libm, native
from marl_traffic_intersection_tpu_torch.ops.lidar_cases import edge_inputs, fuzz_inputs

from ._torch_port import assert_bits
from .test_lidar_fuzz import _random_batch, _random_env_batch

SAMPLES = 63


def _host() -> ctypes.CDLL:
    lib = native.load("lidar_host.cpp")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lidar_scan_host.argtypes = [p] * 10 + [i] * 4
        lib.lidar_scan_host.restype = i
        lib.lidar_samples_host.argtypes = [p, p, ctypes.c_long, p]
        lib.lidar_samples_host.restype = None
        lib._typed = True
    return lib


def _ptrs(*arrays):
    return [ctypes.c_void_p(a.ctypes.data) for a in arrays]


def host_scan(sx, sy, sh, ox, oy, oh, om, num_lanes=3):
    """The header's march on numpy arrays: (B, N, 96) distances and the number
    of boxes each ray keeps after the cull."""
    (b, n), m = sx.shape, ox.shape[1]
    out = np.empty((b, n, 96), np.float32)
    survivors = np.empty((b, n, 96), np.int32)
    ins = [np.ascontiguousarray(a, np.float32) for a in (sx, sy, sh, ox, oy, oh)]
    ins += [np.ascontiguousarray(om, np.uint8), REL_ANGLES]
    assert _host().lidar_scan_host(*_ptrs(*ins, out, survivors), b, n, m, num_lanes) == 0
    return out, survivors


def _check(arrays, num_lanes=3):
    arrays = [np.ascontiguousarray(np.array(a)) for a in arrays]
    got, survivors = host_scan(*arrays, num_lanes=num_lanes)
    want = lidar_scan_ref(*(torch.from_numpy(a) for a in arrays), num_lanes=num_lanes)
    assert_bits("lidar", want, got)
    return arrays, survivors


@pytest.mark.parametrize("kind", ["random", "axis_aligned", "integer_lattice"])
def test_host_march_matches_the_plain_version_single_scanner(kind):
    rng = np.random.RandomState({"random": 10, "axis_aligned": 11, "integer_lattice": 12}[kind])
    sx, sy, sh, ox, oy, oh, om = (np.asarray(a) for a in _random_batch(
        rng, 256, axis_aligned=kind != "random", integer_lattice=kind == "integer_lattice"))
    _check([sx[:, None], sy[:, None], sh[:, None], ox, oy, oh, om])


@pytest.mark.parametrize("agents", [1, 4, 8])
def test_host_march_matches_the_plain_version_env_batches(agents):
    _, survivors = _check(_random_env_batch(np.random.RandomState(20 + agents), 64, agents))
    assert survivors.max() > 0      # some rays keep a box, so the march tests boxes


@pytest.mark.parametrize("m,lanes", [(0, 3), (5, 2), (33, 3), (64, 3)])
def test_host_march_matches_the_plain_version_up_to_64_obstacles(m, lanes):
    _check(fuzz_inputs(30 + m, 48, 4, m), num_lanes=lanes)


def test_host_march_matches_the_plain_version_on_edges():
    """NaN, +-inf, -0.0 and screen-edge poses. A ray whose end samples are
    not finite keeps every box it sees (no cull) and walks them all."""
    (sx, sy, sh, ox, oy, oh, om), survivors = _check(edge_inputs())
    nonfinite = ~(np.isfinite(sx) & np.isfinite(sy) & np.isfinite(sh))
    assert nonfinite.any() and (~nonfinite).any()
    # nothing is within 1e-3 of a non-finite pose, so such a scanner sees
    # every present obstacle
    seen = np.broadcast_to(om.sum(-1)[:, None], sx.shape)
    assert (survivors[nonfinite] == seen[nonfinite][:, None]).all()
    assert survivors[~nonfinite].mean() < seen[~nonfinite].mean()


def _samples(p0, d):
    out = np.empty((len(p0), SAMPLES), np.float32)
    p0, d = np.ascontiguousarray(p0, np.float32), np.ascontiguousarray(d, np.float32)
    _host().lidar_samples_host(*_ptrs(p0, d), len(p0), out.ctypes.data)
    return out


@pytest.mark.parametrize("side", ["left", "right", "top", "bottom"])
def test_the_cull_keeps_a_box_that_only_touches_the_sample_box(side):
    """A box whose edge lies exactly on a ray's extreme sample coordinate may
    be hit there, so the cull must keep it: one env per targeted ray, its one
    obstacle (heading 0: half extents 27 and 12, integer bounds) placed
    just outside the ray's sample box but touching it on one side."""
    rng = np.random.RandomState({"left": 50, "right": 51, "top": 52, "bottom": 53}[side])
    n, rays = 16, np.arange(0, 96, 4)
    sx = rng.uniform(300, 450, n).astype(np.float32)       # inside the crossing,
    sy = rng.uniform(300, 450, n).astype(np.float32)       # far from the grass
    sh = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang = (sh[:, None] + REL_ANGLES[rays]).astype(np.float32)     # one f32 add
    dx = libm.glibc_np("cosf", ang).ravel()
    dy = -libm.glibc_np("sinf", ang).ravel()
    px0, py0 = np.repeat(sx, len(rays)), np.repeat(sy, len(rays))
    xs, ys = _samples(px0, dx), _samples(py0, dy)
    if side == "right":    # lox == the largest x sample, y centred on that end
        j = np.where(dx > 0, SAMPLES - 1, 0)
        ox, oy = xs.max(1) + 27, ys[np.arange(len(j)), j]
    elif side == "left":   # hix == the smallest x sample
        j = np.where(dx < 0, SAMPLES - 1, 0)
        ox, oy = xs.min(1) - 27, ys[np.arange(len(j)), j]
    elif side == "bottom":  # loy == the largest y sample
        j = np.where(dy > 0, SAMPLES - 1, 0)
        ox, oy = xs[np.arange(len(j)), j], ys.max(1) + 12
    else:                  # hiy == the smallest y sample
        j = np.where(dy < 0, SAMPLES - 1, 0)
        ox, oy = xs[np.arange(len(j)), j], ys.min(1) - 12
    b = len(px0)
    batch = [np.repeat(a, len(rays))[:, None] for a in (sx, sy, sh)]
    batch += [ox[:, None].astype(np.float32), oy[:, None].astype(np.float32),
              np.zeros((b, 1), np.float32), np.ones((b, 1), bool)]
    (_, _, _, _, _, _, om), survivors = _check(batch)
    target = survivors[np.arange(b), 0, np.tile(rays, n)]
    assert (target == 1).all()        # the touching box survives its ray's cull
    # and it decides some readings: without it they differ
    without = lidar_scan_ref(*(torch.from_numpy(a) for a in batch[:6]),
                             torch.zeros((b, 1), dtype=torch.bool))
    with_box = host_scan(*batch)[0]
    hit_at_edge = (with_box[np.arange(b), 0, np.tile(rays, n)]
                   != without.numpy()[np.arange(b), 0, np.tile(rays, n)])
    assert hit_at_edge.sum() >= b // 4


def test_samples_are_monotone_in_k():
    """x_k = trunc(fl(p0 + fl(d * 4k))) never turns back along a ray, for
    either sign of d: every sample lies between samples 0 and 62."""
    rng = np.random.RandomState(40)
    n = 200_000
    p0 = rng.uniform(-300, 1050, n).astype(np.float32)
    d = libm.glibc_np("cosf", rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    special = np.asarray([0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30, 1e-8, -1e-8, 0.5, -0.5],
                         np.float32)
    edges = np.asarray([-1.0, -0.5, -0.0, 0.0, 0.5, 749.0, 749.5, 750.0, 1e7, -1e7],
                       np.float32)
    p0 = np.concatenate([p0, np.repeat(edges, len(special))])
    d = np.concatenate([d, np.tile(special, len(edges))])
    out = np.empty((len(p0), SAMPLES), np.float32)
    _host().lidar_samples_host(*_ptrs(p0, d), len(p0), out.ctypes.data)

    dist = np.arange(SAMPLES, dtype=np.float32) * np.float32(4)
    want = np.trunc(p0[:, None] + d[:, None] * dist)       # each f32 op rounds
    assert_bits("samples", want, out)
    step = np.diff(out, axis=1)
    assert (step[d > 0] >= 0).all() and (step[d < 0] <= 0).all() and (step[d == 0] == 0).all()
    assert (d > 0).sum() > n // 3 and (d < 0).sum() > n // 3
