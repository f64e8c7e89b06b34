"""Routes and road geometry of the port against the JAX package.

The route tables are byte-equal (spawn headings by bit pattern: east-bound
ones are -0.0). The geometry tests agree on every pixel of the 750x750
canvas and on seeded off-canvas floats.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core import geometry as jg
from marl_traffic_intersection_tpu.core.routes import build_route_table as jax_table
from marl_traffic_intersection_tpu_torch.core import geometry as pg
from marl_traffic_intersection_tpu_torch.core.routes import build_route_table, default_ego_routes

from . import _torch_port  # noqa: F401  (one torch thread per test worker)


@pytest.mark.parametrize("lanes", [3, 2])
def test_route_table_byte_equal(lanes):
    j, p = jax_table(lanes), build_route_table(lanes)
    for f in ("paths", "spawn_xy", "spawn_heading", "intent", "goal_xy", "goal_prev_xy",
              "traffic_route_ids"):
        a, b = getattr(j, f), getattr(p, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert np.signbit(p.spawn_heading).any()
    routes = default_ego_routes(8, lanes)
    assert (p.route_ids(routes) == j.route_ids(routes)).all()


def _canvas_and_floats():
    xs = np.arange(750, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs)
    rng = np.random.RandomState(0)
    fx = rng.uniform(-120, 870, 200_000).astype(np.float32)
    fy = rng.uniform(-120, 870, 200_000).astype(np.float32)
    return np.concatenate([X.ravel(), fx]), np.concatenate([Y.ravel(), fy])


@pytest.mark.parametrize("lanes", [3, 2])
@pytest.mark.parametrize("fn", ["is_on_road", "off_road_grid_fast", "hits_yellow_line"])
def test_float_geometry_matches(fn, lanes):
    x, y = _canvas_and_floats()
    if fn == "off_road_grid_fast":     # integer-valued coords only
        x, y = np.trunc(x), np.trunc(y)
    j = np.asarray(jax.jit(lambda a, b: getattr(jg, fn)(a, b, lanes))(x, y))
    p = getattr(pg, fn)(torch.from_numpy(x), torch.from_numpy(y), lanes).numpy()
    assert (j == p).all(), (fn, int((j != p).sum()))


@pytest.mark.parametrize("lanes", [3, 2])
def test_line_pixel_matches(lanes):
    xi = np.arange(-5, 760, dtype=np.int32)
    X, Y = (a.ravel() for a in np.meshgrid(xi, xi))
    j = np.asarray(jg.is_line_pixel(jnp.asarray(X), jnp.asarray(Y), lanes))
    p = pg.is_line_pixel(torch.from_numpy(X), torch.from_numpy(Y), lanes).numpy()
    assert (j == p).all()
    assert (p.reshape(len(xi), len(xi))[5:755, 5:755].astype(np.uint8)
            == jg.rasterize_line_mask(lanes)).all()
