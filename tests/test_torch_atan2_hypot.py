"""The redesigned ``atan2f`` and ``hypotf`` and their diff forms on the CPU.

csrc/libm_f32.cuh's ``atanf`` (one division of selected operands),
``atan2f`` (one ``atanf``, no x == 1.0f shortcut) and ``hypotf`` (an fma
sum and a square root with no slow path), built for the CPU
(``transcribed_np``), are bit-equal to the host glibc on structured
operands: the ``atanf`` range switches as ``y/x`` ratios, x == 1.0 against
every class of y, the ``k = +-60`` clamps, the quadrants with zeros,
infinities and NaN, and the env's ``theta_err`` operands. ``atan2f_diff``
and ``hypotf_diff`` are bit-equal to the composition they stand for, signed
zeros and broadcast and interleaved views included, and on the signed-zero
operands with which the card launches ``atan2f`` and ``hypotf`` to the
two-operand forms; the env step and the NPC plan call them, not the
two-operand forms, at the rewritten sites.
"""
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch import EnvConfig, IntersectionEnv, VectorEnv
from marl_traffic_intersection_tpu_torch.core import npc as npc_module
from marl_traffic_intersection_tpu_torch.ops import libm

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

F32 = np.float32
# atanf's range switches (|x| = 0.4375, 0.6875, 1.1875, 2.4375), its |x| <
# 2^-29 and |x| >= 2^25 ends
SWITCHES = (0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** -29, 2.0 ** 25)
SPECIAL = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, 1e-40, -1e-40,
                      1e-45, -1e-45, 3e38, -3e38, 2.5, -2.5, 2.0 ** 60, -(2.0 ** -60)], F32)


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _around(value, width):
    """Every float32 within ``width`` ulps of ``value``, and their negations."""
    b = np.asarray([value], F32).view(np.int32)[0]
    x = (np.arange(-width, width + 1, dtype=np.int32) + b).view(F32)
    return np.concatenate([x, -x])


def _assert_glibc(name, *args):
    a, b = _bits(libm.transcribed_np(name, *args)), _bits(libm.glibc_np(name, *args))
    assert a.shape == b.shape
    bad = a != b
    assert not bad.any(), (f"{bad.sum()} of {a.size} differ, first at "
                           f"{[np.broadcast_to(x, a.shape)[bad][:3] for x in args]}")


def _pairs(kind):
    rng = np.random.RandomState(11)
    if kind == "switch ratios":        # y / x within 200 ulps of each switch
        r = np.concatenate([_around(v, 200) for v in SWITCHES])
        x = np.asarray([1.0, 2.0, 0.125, 2.0 ** 40, 3.0, 1e-3, 750.0], F32)
        y = (r[:, None] * x[None, :]).astype(F32)
        y, x = y.ravel(), np.broadcast_to(x, (len(r), len(x))).ravel()
        return np.concatenate([y, y, -y, -y]), np.concatenate([x, -x, x, -x])
    if kind == "x == 1":               # every class of y against the shortcut glibc takes
        y = np.concatenate([SPECIAL, *(_around(v, 50) for v in SWITCHES),
                            _around(2.0 ** 61, 50), _around(2.0 ** -126, 50),
                            rng.randint(-2 ** 31, 2 ** 31 - 1, 200_000,
                                        dtype=np.int64).astype(np.int32).view(F32)])
        return y, np.ones_like(y)
    if kind == "k = +-60":             # the exponent gap around both clamps
        ix = rng.randint(0x00800000, 0x5f000000, 4000).astype(np.int64)
        gap = np.repeat(np.asarray([-62, -61, -60, -59, 59, 60, 61, 62]), 500)
        iy = np.clip(ix + (gap << 23) + rng.randint(-(1 << 23), 1 << 23, 4000), 1, 0x7f7fffff)
        x, y = ix.astype(np.int32).view(F32), iy.astype(np.int32).view(F32)
        return np.concatenate([y, y, -y, -y, x, -x]), np.concatenate([x, -x, x, -x, y, y])
    if kind == "quadrants":            # zeros, infinities, NaN in every quadrant
        y, x = np.meshgrid(SPECIAL, SPECIAL)
        return y.ravel(), x.ravel()
    if kind == "theta_err":            # atan2f(-dyd, dxd) toward a path point
        ay, by, ax, bx = (rng.uniform(-100, 1100, 200_000).astype(F32) for _ in range(4))
        return -(ay - by), ax - bx
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["switch ratios", "x == 1", "k = +-60", "quadrants",
                                  "theta_err"])
def test_transcribed_atan2f_is_glibc(kind):
    _assert_glibc("atan2f", *_pairs(kind))


def test_transcribed_atanf_is_glibc_around_its_switches():
    x = np.concatenate([SPECIAL, *(_around(v, 200) for v in SWITCHES),
                        np.random.RandomState(12).uniform(-40, 40, 200_000).astype(F32)])
    _assert_glibc("atanf", x)


@pytest.mark.parametrize("kind", ["subnormal", "huge", "zero", "seeded"])
def test_transcribed_hypotf_is_glibc(kind):
    rng = np.random.RandomState(13)
    if kind == "subnormal":
        a = rng.randint(0, 0x00800000, 200_000).astype(np.int32).view(F32)
        b = np.concatenate([a[1:], a[:1]]) * F32(-1.0)
        b[::3] = rng.uniform(-1e-38, 1e-38, len(b[::3])).astype(F32)
    elif kind == "huge":
        a = rng.randint(0x7e000000, 0x7f800000, 200_000).astype(np.int32).view(F32)
        b = np.concatenate([a[7:], a[:7]])
        b[::2] *= F32(-1e-3)
    elif kind == "zero":
        a = np.concatenate([SPECIAL, np.zeros(4, F32), -np.zeros(4, F32)])
        a, b = (t.ravel() for t in np.meshgrid(a, a))
    else:
        a, b = (rng.uniform(-1200, 1200, 200_000).astype(F32) for _ in range(2))
    _assert_glibc("hypotf", a, b)
    _assert_glibc("hypotf", b, a)


def test_hypotf_square_root_is_correctly_rounded():
    """The header's sqrt_normal against the library's sqrt on doubles: random
    ones over hypotf's range, (near) squares and (near) squares of
    midpoints, and powers of two and their neighbours."""
    rng = np.random.RandomState(14)
    s = [np.ldexp(rng.uniform(1, 2, 100_000), rng.randint(-298, 257, 100_000))]
    g = np.ldexp(rng.uniform(1, 2, 100_000), rng.randint(-149, 128, 100_000))
    for sq in (g * g, (g + np.spacing(g) / 2) ** 2):
        s += [(sq.view(np.int64) + d).view(np.float64) for d in (-2, -1, 0, 1, 2)]
    p2 = np.ldexp(1.0, np.arange(-298, 257)).view(np.int64)
    s += [(p2 + d).view(np.float64) for d in range(-3, 4)]
    s = np.concatenate(s)
    assert (libm.sqrt_normal_np(s).view(np.int64) == np.sqrt(s).view(np.int64)).all()


def _operands(rng, shape):
    return [torch.from_numpy(rng.uniform(-100, 1100, shape).astype(F32)) for _ in range(4)]


def _views(kind):
    """Four operands as the call sites pass them: contiguous; broadcast
    against a pose; interleaved in a (B, S, P, 2) path; against a 0-d
    constant."""
    rng = np.random.RandomState(15)
    if kind == "contiguous":
        return _operands(rng, (64, 4))
    if kind == "broadcast":
        a, b, c, d = _operands(rng, (16, 1, 6))
        return a, b.reshape(16, 6, 1), c, d.reshape(16, 6, 1)
    if kind == "interleaved":
        path = torch.from_numpy(rng.uniform(-100, 1100, (8, 3, 20, 2)).astype(F32))
        sx, sy = (torch.from_numpy(rng.uniform(-100, 1100, (8, 3)).astype(F32)) for _ in "xy")
        return path[..., 0], sx[..., None], path[..., 1], sy[..., None]
    if kind == "constant":
        a, _, c, _ = _operands(rng, (32, 5))
        return a, libm.const(400.0, "cpu"), c, libm.const(375.0, "cpu")
    if kind == "equal":                # a == b: -(a - b) is -0.0
        a, b, c, d = _operands(rng, (256,))
        b[::2] = a[::2]
        d[::3] = c[::3]
        c[::5] = d[::5]
        return a, b, c, d
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["contiguous", "broadcast", "interleaved", "constant", "equal"])
def test_diff_forms_are_their_composition(kind):
    ay, by, ax, bx = _views(kind)
    got = libm.atan2f_diff(ay, by, ax, bx)
    want = libm.atan2f(-(ay - by), ax - bx)
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))
    got = libm.hypotf_diff(ay, by, ax, bx)
    want = libm.hypotf(ay - by, ax - bx)
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the header's diff forms, which the card's kernels run, against glibc's
    arrays = [np.broadcast_to(t.numpy(), got.shape) for t in (ay, by, ax, bx)]
    for name in ("atan2f_diff", "hypotf_diff"):
        _assert_glibc(name, *arrays)


@pytest.mark.parametrize("kind", ["quadrants", "k = +-60", "theta_err"])
def test_two_operand_forms_are_their_diff_kernels(kind):
    """The card launches atan2f(y, x) as atan2f_diff(-0.0, y, x, 0.0) and
    hypotf(x, y) as hypotf_diff(x, 0.0, y, 0.0): the header's diff forms on
    those operands are bit-equal to its two-operand forms (NaN for NaN)."""
    y, x = _pairs(kind)
    nz, z = F32(-0.0), F32(0.0)
    for got, want in ((libm.transcribed_np("atan2f_diff", nz, y, x, z),
                       libm.transcribed_np("atan2f", y, x)),
                      (libm.transcribed_np("hypotf_diff", y, z, x, z),
                       libm.transcribed_np("hypotf", y, x))):
        nan = np.isnan(want)
        assert (np.isnan(got) == nan).all() and (_bits(got)[~nan] == _bits(want)[~nan]).all()


def test_atan2f_diff_negates_the_difference():
    """Where ay == by and ax < bx, -(ay - by) is -0.0: -pi, where the swapped
    difference (by - ay = +0.0) gives +pi."""
    a = torch.tensor([5.0, 5.0, 5.0], dtype=torch.float32)
    ax = torch.tensor([1.0, 9.0, 5.0], dtype=torch.float32)
    got = libm.atan2f_diff(a, a, ax, torch.full((3,), 5.0))
    assert got.tolist()[0] == -float(np.float32(np.pi))
    assert _bits(got.numpy()).tolist()[1:] == _bits([-0.0, -0.0]).tolist()
    assert libm.atan2f(a - a, ax - 5.0).tolist()[0] == float(np.float32(np.pi))


@pytest.mark.parametrize("kind", ["contiguous", "broadcast", "interleaved", "constant"])
def test_geometry_addresses_every_operand(kind):
    """The sizes and strides the card's strided launch gets address every
    element of every operand: each operand read through them is its view
    broadcast to the output's shape, and contiguous neighbours are merged."""
    xs = _views(kind)
    sizes, strides = libm.geometry(xs)
    assert len(sizes) <= libm.MAX_DIMS
    for x, st, full in zip(xs, strides, torch.broadcast_tensors(*xs)):
        read = torch.as_strided(x, sizes, st, x.storage_offset())
        assert torch.equal(read.reshape(full.shape), full)
    assert len(sizes) == {"contiguous": 1, "broadcast": 3, "interleaved": 2, "constant": 1}[kind]


@pytest.mark.parametrize("traffic", [False, True])
def test_env_step_and_plan_call_the_diff_forms(monkeypatch, traffic):
    """The env step and observation call atan2f only through atan2f_diff and
    hypotf through hypotf_diff, but for the plan's two distances whose
    differences it uses again (npc.py's dist and fmag): two two-operand
    hypotf calls per plan, none of atan2f."""
    calls, plans = [], []
    apply, plan = libm._apply, npc_module._plan
    monkeypatch.setattr(libm, "_apply", lambda name, *xs: calls.append(name) or apply(name, *xs))
    monkeypatch.setattr(npc_module, "_plan", lambda *a: plans.append(1) or plan(*a))
    cfg = EnvConfig(num_agents=2, traffic_flow=traffic, traffic_density=3.0, max_npcs=8)
    venv = VectorEnv(IntersectionEnv(cfg, device="cpu"), num_envs=4, seed=0)
    state, _ = venv.reset()
    for _ in range(3):
        state, _ = venv.step(state, torch.full((4, 2, 2), 0.5))
    assert calls.count("atan2f") == 0 and calls.count("hypotf") == 2 * len(plans)
    assert calls.count("atan2f_diff") >= 3 + len(plans)
    assert calls.count("hypotf_diff") >= 3 + 3 * len(plans)
    assert bool(plans) == traffic
