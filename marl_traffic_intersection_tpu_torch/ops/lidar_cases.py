"""Seeded inputs on which kernel K1 is held against its plain version.

Each function returns numpy arrays ``(sx, sy, sh, ox, oy, oh, om)``: scanner
poses (B, N) float32, obstacle poses (B, M) float32 and presence (B, M) bool.
chip_smoke.py feeds them to the kernel on the card, and the tests to the CPU
build of its ray body (csrc/lidar_host.cpp).
"""
from __future__ import annotations

import numpy as np

AXIS_HEADINGS = np.asarray([0, np.pi / 2, -np.pi / 2, np.pi, -np.pi], np.float32)


def fuzz_inputs(seed: int, b: int, n: int, m: int, axis_aligned: bool = False,
                lattice: bool = False):
    """Poses over and beyond the screen; the first min(n, m) obstacles are the
    scanners themselves, as in the env, so the self test is exercised."""
    r = np.random.RandomState(seed)
    sx = r.uniform(-250, 1000, (b, n)).astype(np.float32)
    sy = r.uniform(-250, 1000, (b, n)).astype(np.float32)
    sh = (r.choice(AXIS_HEADINGS, (b, n)) if axis_aligned
          else r.uniform(-np.pi, np.pi, (b, n)).astype(np.float32))
    ox = r.uniform(-50, 800, (b, m)).astype(np.float32)
    oy = r.uniform(-50, 800, (b, m)).astype(np.float32)
    oh = r.uniform(-np.pi, np.pi, (b, m)).astype(np.float32)
    if lattice:
        ox, oy = np.round(ox), np.round(oy)
        oh = r.choice(np.asarray([0.0, np.pi / 2], np.float32), (b, m))
        sx, sy = np.round(sx), np.round(sy)
    om = r.uniform(size=(b, m)) < r.uniform(0.1, 1.0, (b, 1))
    k = min(n, m)
    ox[:, :k], oy[:, :k], oh[:, :k], om[:, :k] = sx[:, :k], sy[:, :k], sh[:, :k], True
    return sx, sy, sh, ox, oy, oh, om


# Coordinates on and around the screen edges (samples truncate toward zero:
# trunc(-0.5) is -0.0, which is on the screen) and non-finite ones.
EDGE_COORDS = np.asarray([-1.0, -0.5, -0.0, 0.0, 0.5, 3.75, 120.0, 375.0, 625.25, 749.0,
                          749.5, 750.0, 750.5, np.nan, np.inf, -np.inf], np.float32)
EDGE_HEADINGS = np.asarray([0.0, -0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 0.75, -2.5,
                            1e-8, np.nan, np.inf, -np.inf], np.float32)


def edge_inputs(seed: int = 0, n: int = 2, m: int = 12):
    """Every (x, y, heading) of EDGE_COORDS x EDGE_COORDS x EDGE_HEADINGS as a
    scanner, n to an env, against obstacles drawn from the same values, from
    near the scanner, and from the other scanners of the env."""
    r = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(EDGE_COORDS, EDGE_COORDS, EDGE_HEADINGS, indexing="ij"),
                    -1).reshape(-1, 3)
    grid = grid[r.permutation(len(grid))]
    b = len(grid) // n
    sx, sy, sh = (np.ascontiguousarray(grid[:b * n, j].reshape(b, n)) for j in range(3))
    ox = r.choice(EDGE_COORDS, (b, m))
    oy = r.choice(EDGE_COORDS, (b, m))
    oh = r.choice(EDGE_HEADINGS, (b, m))
    near = r.uniform(size=(b, m)) < 0.5        # a car within 40 px of scanner 0
    with np.errstate(invalid="ignore"):
        ox = np.where(near, sx[:, :1] + r.uniform(-40, 40, (b, m)), ox)
        oy = np.where(near, sy[:, :1] + r.uniform(-40, 40, (b, m)), oy)
        oh = np.where(near, r.choice(AXIS_HEADINGS, (b, m)), oh)
    om = r.uniform(size=(b, m)) < 0.8
    k = min(n, m)
    ox[:, :k], oy[:, :k], oh[:, :k], om[:, :k] = sx[:, :k], sy[:, :k], sh[:, :k], True
    return (sx, sy, sh, ox.astype(np.float32), oy.astype(np.float32),
            oh.astype(np.float32), om)
