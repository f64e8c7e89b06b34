"""The plain version of kernel K1 (core/lidar.py::lidar_scan_ref) against the
JAX package's ``lidar_scan``, bit for bit, on the fuzz generators of
tests/test_lidar_fuzz.py: random poses over and beyond the screen with 36
obstacle slots, axis-aligned headings, the integer lattice, and env-shaped
batches where the egos are in the obstacle set."""
import jax
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core.lidar import lidar_scan, ray_rel_angles
from marl_traffic_intersection_tpu_torch.core import lidar as pl
from marl_traffic_intersection_tpu_torch.ops.lidar_cuda import lidar_scan as k1_wrapper

from ._torch_port import assert_bits
from .test_lidar_fuzz import M, _random_batch, _random_env_batch

_jax_single = jax.jit(jax.vmap(lambda sx, sy, sh, ox, oy, oh, om: lidar_scan(
    sx, sy, sh, ox, oy, oh, om, 3)))
_jax_env = jax.jit(jax.vmap(lambda sx, sy, sh, ox, oy, oh, om: jax.vmap(
    lambda a, b, c: lidar_scan(a, b, c, ox, oy, oh, om, 3))(sx, sy, sh)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ray_angle_table_matches():
    assert ray_rel_angles().tobytes() == pl.REL_ANGLES.tobytes()


@pytest.mark.parametrize("kind", ["random", "axis_aligned", "integer_lattice"])
def test_plain_lidar_matches_jax_single_scanner(kind):
    rng = np.random.RandomState({"random": 0, "axis_aligned": 1, "integer_lattice": 2}[kind])
    batch = _random_batch(rng, 384, axis_aligned=kind != "random",
                          integer_lattice=kind == "integer_lattice")
    sx, sy, sh, ox, oy, oh, om = (_t(a) for a in batch)
    assert ox.shape[1] == M
    got = pl.lidar_scan_ref(sx[:, None], sy[:, None], sh[:, None], ox, oy, oh, om)
    assert_bits("lidar", np.asarray(_jax_single(*batch)), got[:, 0])


@pytest.mark.parametrize("agents", [1, 4, 8])
def test_plain_lidar_matches_jax_env_batches(agents):
    batch = _random_env_batch(np.random.RandomState(7), 128, agents=agents)
    got = pl.lidar_scan_ref(*(_t(a) for a in batch))
    assert_bits("lidar", np.asarray(_jax_env(*batch)), got)


def test_marched_sample_count():
    """The count the bound uses: up to and including the first event."""
    batch = _random_env_batch(np.random.RandomState(9), 64, agents=4)
    out, samples = pl.lidar_scan_ref(*(_t(a) for a in batch), return_samples=True)
    hit = out < 250.0
    assert (samples[hit] == (out[hit] / 4).int() + 1).all()
    assert ((samples >= 1) & (samples <= 63)).all()


def test_k1_wrapper_takes_the_plain_version_on_cpu():
    batch = [_t(a) for a in _random_env_batch(np.random.RandomState(11), 16, agents=4)]
    assert_bits("lidar", pl.lidar_scan_ref(*batch), k1_wrapper(*batch))
