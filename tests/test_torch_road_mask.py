"""The port's RoadMask helpers (core/geometry.py) against the JAX package's:
the pixel obstacle grid, the analytic pixel test on every pixel of the
screen and 5 px around it, and the rasterized yellow-line grid, at 2 and 3
lanes, bit for bit (tests/test_utils_entry.py::test_road_mask_parity for
the port)."""
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core import geometry as jgeo
from marl_traffic_intersection_tpu_torch.core import geometry
from marl_traffic_intersection_tpu_torch.core.constants import HEIGHT, WIDTH

LANES = (2, 3)
PAD = 5


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", ["road_obstacle_mask", "rasterize_line_mask"])
def test_grids_bit_equal_to_jax(name, lanes):
    got, want = getattr(geometry, name)(lanes), getattr(jgeo, name)(lanes)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (HEIGHT, WIDTH)
    assert np.array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("lanes", LANES)
def test_is_obstacle_pixel_equals_jax_and_the_grid(lanes):
    ys, xs = np.mgrid[-PAD:HEIGHT + PAD, -PAD:WIDTH + PAD].astype(np.int32)
    got = geometry.is_obstacle_pixel(torch.from_numpy(xs), torch.from_numpy(ys), lanes)
    assert got.dtype == torch.bool
    got = got.numpy()
    assert np.array_equal(got, np.asarray(jgeo.is_obstacle_pixel(xs, ys, lanes)))
    inside = got[PAD:-PAD, PAD:-PAD]
    assert np.array_equal(inside, geometry.road_obstacle_mask(lanes).astype(bool))
    assert not got[:PAD].any() and not got[-PAD:].any()           # off the screen: no hit
    assert not got[:, :PAD].any() and not got[:, -PAD:].any()
