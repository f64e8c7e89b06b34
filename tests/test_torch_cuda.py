"""Kernels of the port on the card, held against their plain versions.

Marked ``cuda``: each test asks for a card and nvcc when it runs and skips
without them (run with ``python -m pytest -m cuda tests/test_torch_cuda.py``
on a machine with an H100). The kernels are built with nvcc at first use.
"""
import shutil

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core.constants import STATUS_ALIVE, STATUS_CRASH_LINE
from marl_traffic_intersection_tpu_torch.core.env import EgoTick, ego_step_ref
from marl_traffic_intersection_tpu_torch.core.lidar import lidar_scan_ref
from marl_traffic_intersection_tpu_torch.core import env as env_module, npc
from marl_traffic_intersection_tpu_torch.core.npc import move_ref
from marl_traffic_intersection_tpu_torch.ops import libm, native
from marl_traffic_intersection_tpu_torch.ops import ego_step_cases
from marl_traffic_intersection_tpu_torch.ops.ego_step_cuda import ego_step
from marl_traffic_intersection_tpu_torch.ops.lidar_cases import edge_inputs, fuzz_inputs
from marl_traffic_intersection_tpu_torch.ops.lidar_cuda import lidar_scan
from marl_traffic_intersection_tpu_torch.ops.npc_move_cases import CASES, case_args, on
from marl_traffic_intersection_tpu_torch.ops.npc_move_cuda import npc_move
from marl_traffic_intersection_tpu_torch.utils.graphs import stat_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not shutil.which("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _bits(t):
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("name", ["sinf", "cosf", "tanf", "atan2f", "hypotf"])
def test_libm_kernels_match_the_cpu_transcription(card, name):
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-7, 7, 1 << 20), [0.0, -0.0, np.pi / 2, -np.pi / 2,
                                                     np.pi, -np.pi]]).astype(np.float32)
    args = [x] if name in ("sinf", "cosf", "tanf") else [x[::-1].copy() * 50, x * 50]
    got = getattr(libm, name)(*(torch.from_numpy(a).to(card) for a in args))
    torch.cuda.synchronize()
    assert (_bits(got) == libm.transcribed_np(name, *args).view(np.int32)).all()


def _trig_operand(shape, card):
    """Seeded uniform(-7, 7) operands of ``shape`` on the card, ending in
    edge values; "broadcast" is sat_overlap's view of torch.broadcast_tensors,
    "steering" the angles car_physics_step passes."""
    rng = np.random.RandomState(1)
    if shape == "broadcast":
        a = torch.from_numpy(rng.uniform(-7, 7, (4096, 4, 1)).astype(np.float32)).to(card)
        b = torch.from_numpy(rng.uniform(-7, 7, (4096, 1, 4)).astype(np.float32)).to(card)
        return torch.broadcast_tensors(a, b)[0]
    if shape == "steering":
        return torch.from_numpy(rng.uniform(-0.6108652, 0.6108652, (4096, 4))
                                .astype(np.float32)).to(card)
    x = rng.uniform(-7, 7, int(np.prod(shape))).astype(np.float32)
    edges = np.asarray([0.0, -0.0, 2.0 ** -12, -(2.0 ** -13), np.pi / 4, -np.pi / 4, 119.99,
                        -119.99, 1e-40, -1e-45], np.float32)[:x.size]
    x[len(x) - len(edges):] = edges
    return torch.from_numpy(x.reshape(shape)).to(card)


TRIG_SHAPES = [(0,), (1,), (4096, 4), (4096, 8, 96), "broadcast", "steering"]


@pytest.mark.parametrize("shape", TRIG_SHAPES, ids=str)
def test_sincosf_kernel_matches_the_cpu_transcription(card, shape):
    x = _trig_operand(shape, card)
    native.reset_launches()
    s, c = libm.sincosf(x)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sincosf"] == 1 and s.shape == c.shape == x.shape
    ws, wc = libm.transcribed_np("sincosf", x.cpu().numpy())
    assert (_bits(s) == ws.view(np.int32)).all() and (_bits(c) == wc.view(np.int32)).all()
    assert torch.equal(libm.sinf(x).view(torch.int32), s.view(torch.int32))
    assert torch.equal(libm.cosf(x).view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("shape", TRIG_SHAPES, ids=str)
def test_tanf_kernel_matches_the_cpu_transcription(card, shape):
    x = _trig_operand(shape, card)
    got = libm.tanf(x)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    assert (_bits(got) == libm.transcribed_np("tanf", x.cpu().numpy()).view(np.int32)).all()


def _strided_operands(kind, card):
    """Four operands on the card as the env's and the NPC plan's call sites
    pass them (views read in place), some pairs equal (-(a - a) is -0.0)."""
    rng = np.random.RandomState(2)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-100, 1100, shape).astype(np.float32)).to(card)
    if kind == "contiguous (4096, 4)":
        a, b, c, d = (u(4096, 4) for _ in range(4))
        b[::3], d[1::4] = a[::3], c[1::4]
        return a, b, c, d
    if kind == "path (4096, 8, 160)":
        path, pose = u(4096, 8, 160, 2), u(2, 4096, 8)
        return path[..., 0], pose[0, ..., None], path[..., 1], pose[1, ..., None]
    if kind == "goal (4096, 8)":
        goal = u(4096, 8, 2)
        return u(4096, 8), goal[..., 0], u(4096, 8), goal[..., 1]
    if kind == "constant (4096, 8)":
        return u(4096, 8), libm.const(400.0, card), u(4096, 8), libm.const(375.0, card)
    if kind == "broadcast (64, 8, 8)":
        return u(64, 1, 8), u(64, 8, 1), u(64, 1, 8), u(64, 8, 1)
    raise ValueError(kind)


STRIDED_CASES = ["contiguous (4096, 4)", "path (4096, 8, 160)", "goal (4096, 8)",
                 "constant (4096, 8)", "broadcast (64, 8, 8)"]


@pytest.mark.parametrize("kind", STRIDED_CASES)
def test_strided_kernels_match_the_cpu(card, kind):
    """atan2f_diff and hypotf_diff, one launch each on views read in place,
    and atan2f and hypotf on two of the views (one launch of the diff
    kernel), bit-equal to the same calls on the CPU (torch's subtractions,
    then the host glibc)."""
    xs = _strided_operands(kind, card)
    cpu = [x.cpu() for x in xs]
    for name, args in (("atan2f_diff", range(4)), ("hypotf_diff", range(4)),
                       ("atan2f", (0, 1)), ("hypotf", (2, 1))):
        fn = getattr(libm, name)
        native.reset_launches()
        got = fn(*(xs[i] for i in args))
        torch.cuda.synchronize()
        want = fn(*(cpu[i] for i in args))
        assert dict(native.LAUNCHES) == {libm.KERNEL_OF.get(name, name): 1}
        assert got.shape == want.shape and (_bits(got) == _bits(want)).all(), name


def test_trig_kernels_out_of_domain_give_nan(card):
    """inf and NaN give NaN (the card's NaN bits are its own)."""
    x = torch.tensor([np.inf, -np.inf, np.nan], device=card)
    for got in (*libm.sincosf(x), libm.tanf(x)):
        assert bool(torch.isnan(got).all())


def _env_batch(rng, b, n, m):
    sx = rng.uniform(-250, 1000, (b, n)).astype(np.float32)
    sy = rng.uniform(-250, 1000, (b, n)).astype(np.float32)
    sh = rng.uniform(-np.pi, np.pi, (b, n)).astype(np.float32)
    ox = rng.uniform(-50, 800, (b, m)).astype(np.float32)
    oy = rng.uniform(-50, 800, (b, m)).astype(np.float32)
    oh = rng.uniform(-np.pi, np.pi, (b, m)).astype(np.float32)
    om = rng.uniform(size=(b, m)) < 0.7
    k = min(n, m)
    ox[:, :k], oy[:, :k], oh[:, :k], om[:, :k] = sx[:, :k], sy[:, :k], sh[:, :k], True
    return [torch.from_numpy(a) for a in (sx, sy, sh, ox, oy, oh, om)]


@pytest.mark.parametrize("b,n,m", [(64, 4, 4), (32, 1, 36), (16, 8, 36), (8, 12, 12)])
def test_k1_matches_the_plain_version(card, b, n, m):
    args = [a.to(card) for a in _env_batch(np.random.RandomState(b + n + m), b, n, m)]
    before = native.LAUNCHES["lidar_scan"]
    got = lidar_scan(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["lidar_scan"] == before + 1
    assert (_bits(got) == _bits(lidar_scan_ref(*args))).all()


@pytest.mark.parametrize("case", ["edges", "fuzz 64 slots"])
def test_k1_edge_poses_and_64_slots_match_the_plain_version(card, case):
    """NaN, +-inf, -0.0 and screen-edge poses, and the upper half of the
    64-bit obstacle mask."""
    arrays = edge_inputs(n=8) if case == "edges" else fuzz_inputs(3, 64, 8, 64)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in arrays]
    got = lidar_scan(*args)
    torch.cuda.synchronize()
    assert (_bits(got) == _bits(lidar_scan_ref(*args))).all()


def test_k1_rejects_what_it_does_not_take(card):
    args = [a.to(card) for a in _env_batch(np.random.RandomState(1), 4, 2, 3)]
    with pytest.raises(ValueError):
        lidar_scan(*args[:6], args[6].int())
    with pytest.raises(ValueError):
        lidar_scan(args[0].t(), *args[1:])
    many = [a.to(card) for a in _env_batch(np.random.RandomState(2), 4, 2, 65)]
    with pytest.raises(ValueError):
        lidar_scan(*many)


@pytest.mark.parametrize("kind,width", CASES)
def test_npc_move_kernel_matches_the_plain_version(card, kind, width):
    """K2, one launch, bit-equal to move_ref on the card and on the CPU."""
    args = on(case_args(kind, width, envs=64), card)
    native.reset_launches()
    got = npc_move(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["npc_move"] == 1
    for g, c, h in zip(got, move_ref(*args), move_ref(*on(args, "cpu"))):
        assert g.dtype == h.dtype and (_bits(g) == _bits(c)).all() and (_bits(g) == _bits(h)).all()


def test_npc_move_kernel_replays_in_a_graph(card):
    """_move captured in a CUDA graph launches K2 and replays it on new poses."""
    args = on(case_args("dense", 16, envs=64), card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        npc._move(*args)                    # loads the library outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = npc._move(*args)
    args[0].add_(1.5)                       # the planners move; the pool does not
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, move_ref(*args)):
        assert (_bits(g) == _bits(w)).all()


def test_npc_move_rejects_what_it_does_not_take(card):
    args = on(case_args("slot", 8), card)
    with pytest.raises(ValueError, match="others"):
        npc_move(*args[:8], args[8].to(torch.uint8), *args[9:])
    with pytest.raises(ValueError, match="contiguous"):
        npc_move(torch.cat([args[0], args[0]], 1)[:, :1], *args[1:])
    with pytest.raises(ValueError, match="path"):
        npc_move(*args[:7], args[7][:, :, :100], *args[8:])


def _k3(args) -> EgoTick:
    """K3 on ego_step_ref's arguments, as core/env.py::ego_step assembles it."""
    native.reset_launches()
    tick = env_module.ego_step(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ego_step"] == 1, dict(native.LAUNCHES)
    return tick


K3_CASES = [(name, 64) for name in ego_step_cases.CASES] + [("n4", 4096), ("n8 w8", 4096),
                                                            ("n8 w16 team", 4096)]


@pytest.mark.parametrize("name,envs", K3_CASES, ids=str)
def test_k3_matches_the_plain_version(card, name, envs):
    """K3, one launch, bit-equal to ego_step_ref on the card (NaNs as NaNs)
    and, but for the edge envs' NaN truncation, on the CPU; at 4096 x 4
    without NPCs and 4096 x 8 with 8 and 16 slots, the main path's shapes."""
    args = ego_step_cases.case_args(name, envs)
    on_card = ego_step_cases.on(args, card)
    got = ego_step_cases.tick_bits(_k3(on_card))
    want = ego_step_cases.tick_bits(ego_step_ref(*on_card))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, i, int((g != w).sum()))
    if name != "edges":
        for i, (g, h) in enumerate(zip(got, ego_step_cases.tick_bits(ego_step_ref(*args)))):
            assert torch.equal(g, h), (name, "cpu", i, int((g != h).sum()))
    else:
        # a NaN corner truncates to 0 on the card (cvt.rzi), a pixel of the
        # line mask; on the CPU to INT32_MIN, off it
        b = ego_step_cases.EDGE_ENVS.index("nan on the line mask")
        status = EgoTick._fields.index("status") - 1 + len(args[0])
        assert got[status][b, 0] == STATUS_CRASH_LINE
        assert ego_step_cases.tick_bits(ego_step_ref(*args))[status][b, 0] == STATUS_ALIVE


def test_k3_launches_once_per_graphed_step(card):
    """The graphed VectorEnv step launches K3 once a step, with and without
    NPCs (the exact mode's cleanup rounds notwithstanding); the plain
    version's chain never runs on the card."""
    import marl_traffic_intersection_tpu_torch as P
    plain = P.VectorEnv(P.IntersectionEnv(P.EnvConfig(num_agents=4, max_steps=20), device=card),
                        num_envs=64, seed=3)
    for venv, n in ((plain, 4), (_traffic_venv(card, 64, "exact"), 8)):
        step = venv.jit_step()
        state, _ = venv.reset()
        rng = np.random.RandomState(8)
        counts = []
        for t in range(30):
            a = torch.from_numpy(rng.uniform(-1, 1, (64, n, 2)).astype(np.float32)).to(card)
            native.reset_launches()
            state, *_ = step(state, a)
            counts.append(native.LAUNCHES["ego_step"])
        torch.cuda.synchronize()
        assert counts == [1] * 30, counts


def test_k3_rejects_what_it_does_not_take(card):
    args = ego_step_cases.on(ego_step_cases.case_args("n8 w8", 16), card)
    ego, actions, *rest = args
    with pytest.raises(ValueError, match="CUDA"):
        ego_step(*ego_step_cases.on(args, "cpu"))
    with pytest.raises(ValueError, match="actions must be"):
        ego_step(ego, actions.double(), *rest)
    with pytest.raises(ValueError, match="y must be"):
        ego_step(ego._replace(y=ego.y.cpu()), actions, *rest)
    wide = ego_step_cases.on(ego_step_cases.case_args("n32 w8 team", 16), card)
    wide_ego = type(ego)(*(torch.cat([t, t[:, :1]], 1) for t in wide[0]))
    with pytest.raises(ValueError, match="1 to 32 agents"):
        ego_step(wide_ego, torch.cat([wide[1], wide[1][:, :1]], 1), *wide[2:])


def test_env_on_the_card_equals_the_cpu(card):
    import marl_traffic_intersection_tpu_torch as P
    outs = {}
    for dev in ("cpu", card):
        env = P.IntersectionEnv(P.EnvConfig(num_agents=4, max_steps=40), device=dev)
        pool = env.table.route_ids(P.default_ego_routes(12, 3))
        rng = np.random.RandomState(4)

        def sampler(k, rng=rng, pool=pool, dev=dev):
            ids = np.stack([pool[rng.permutation(len(pool))[:4]] for _ in range(k)])
            return torch.from_numpy(ids.astype(np.int32)).to(dev)

        venv = P.VectorEnv(env, num_envs=8, route_sampler=sampler)
        state, obs = venv.reset()
        arng = np.random.RandomState(5)
        hist = [obs.cpu()]
        for _ in range(60):
            a = torch.from_numpy(arng.uniform(-1, 1, (8, 4, 2)).astype(np.float32)).to(dev)
            state, out = venv.step(state, a)
            hist += [out.obs.cpu(), out.reward.cpu(), state.ego.x.cpu(), out.status.cpu()]
        outs[str(dev)] = hist
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def test_division_by_a_constant_is_ieee_on_the_card(card):
    """``libm.div`` divides by a device-resident constant: an IEEE division,
    which PyTorch would turn into a reciprocal multiply for a Python scalar
    (ROADMAP queue 3, H9)."""
    x = np.random.RandomState(9).uniform(0, 1000, 1 << 20).astype(np.float32)
    for c in (54.0, 750.0, 250.0, 0.6108652381980153):
        got = libm.div(torch.from_numpy(x).to(card), c)
        assert (_bits(got) == (x / np.float32(c)).view(np.int32)).all(), c


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_traffic_env_on_the_card_equals_the_cpu(card, mode):
    """BASELINE config 4 (8 agents, density 1.0, 32 NPC slots) with injected
    spawns: the card's run, NPC pool included, is bit-equal to the CPU's."""
    import marl_traffic_intersection_tpu_torch as P
    outs = {}
    for dev in ("cpu", card):
        env = P.IntersectionEnv(P.EnvConfig(num_agents=8, traffic_flow=True, traffic_density=1.0,
                                            npc_mode=mode, max_steps=50), device=dev)
        pool = env.table.route_ids(P.default_ego_routes(12, 3))
        T = env.traffic_ids.shape[0]
        rng, srng, arng = (np.random.RandomState(s) for s in (4, 6, 5))

        def routes(k, rng=rng, pool=pool, dev=dev):
            ids = np.stack([pool[rng.permutation(len(pool))[:8]] for _ in range(k)])
            return torch.from_numpy(ids.astype(np.int32)).to(dev)

        def spawns(k, srng=srng, T=T, dev=dev):
            return (torch.from_numpy(srng.uniform(size=k) < 0.3).to(dev),
                    torch.from_numpy(srng.randint(T, size=k).astype(np.int32)).to(dev))

        venv = P.VectorEnv(env, num_envs=8, route_sampler=routes, spawn_sampler=spawns)
        state, obs = venv.reset()
        hist = [obs.cpu()]
        for _ in range(100):
            a = np.stack([arng.uniform(0.2, 1.0, (8, 8)), arng.uniform(-0.2, 0.2, (8, 8))], -1)
            state, out = venv.step(state, torch.from_numpy(a.astype(np.float32)).to(dev))
            hist += [out.obs.cpu(), out.reward.cpu(), out.status.cpu(), out.spawned.cpu()]
            hist += [t.cpu() for t in state.npc] + [state.lidar.cpu()]
        outs[str(dev)] = hist
    assert sum(int(h.sum()) for h in outs["cpu"][4::15]) > 0      # NPCs spawned
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def _graph_runs(card, steps, final_every=0):
    """``steps`` steps of the eager and of the graphed (jit_step) VectorEnv
    at 64 x 4, episodes of 20 steps, the same seeded actions: each a list of
    host copies of (state leaves, out leaves[, final obs]) per step."""
    import marl_traffic_intersection_tpu_torch as P
    from marl_traffic_intersection_tpu_torch.utils.graphs import leaves
    runs = []
    for graphed in (False, True):
        venv = P.VectorEnv(P.IntersectionEnv(P.EnvConfig(num_agents=4, max_steps=20),
                                             device=card), num_envs=64, seed=3)
        step = venv.jit_step() if graphed else venv.step
        state, _ = venv.reset()
        rng, hist = np.random.RandomState(8), []
        for t in range(steps):
            a = torch.from_numpy(rng.uniform(-1, 1, (64, 4, 2)).astype(np.float32)).to(card)
            final = bool(final_every) and t % final_every == 0
            state, *rest = step(state, a, final_obs=final)
            hist.append([x.cpu() for x in leaves((state, rest))])
        runs.append(hist)
    return runs


def test_graphed_step_equals_the_eager_step(card):
    """VectorEnv.jit_step() replays a CUDA graph of the eager step's kernels:
    bit-equal to ``step`` over 50 steps with auto-resets, both final_obs."""
    eager, graphed = _graph_runs(card, 50, final_every=4)
    assert sum(int(h[-4].sum()) + int(h[-3].sum()) for h in eager) > 0     # resets ran
    for t, (a, b) in enumerate(zip(eager, graphed)):
        assert len(a) == len(b), t
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), t


def test_graphed_step_takes_its_own_state_back_without_a_copy(card, monkeypatch):
    """With donation the returned state is the graph's static input: passed
    back in, it is not copied; another state is copied in."""
    import marl_traffic_intersection_tpu_torch as P
    from marl_traffic_intersection_tpu_torch.utils import graphs
    venv = P.VectorEnv(P.IntersectionEnv(P.EnvConfig(num_agents=4), device=card), num_envs=64)
    step = venv.jit_step()
    state, _ = venv.reset()
    a = torch.zeros((64, 4, 2), device=card)
    s1, _ = step(state, a)
    s2, _ = step(s1, a)
    assert s2 is s1 and s1 is step.state
    copies = []                 # the state leaves copied in
    real = graphs.copy_tree_

    def counted(dst, src):
        if dst is step.state:
            copies.extend(x for x, y in zip(graphs.leaves(dst), graphs.leaves(src))
                          if x.numel() and x.data_ptr() != y.data_ptr())
        return real(dst, src)

    monkeypatch.setattr(graphs, "copy_tree_", counted)
    s3, _ = step(s2, a)
    assert copies == [] and s3 is step.state
    fresh, _ = venv.reset()
    s4, _ = step(fresh, a)
    assert len(copies) == len([x for x in graphs.leaves(fresh) if x.numel()])
    assert s4 is step.state


def test_a_capture_that_fails_raises(card):
    """A host read inside a graph cannot be captured: the capture raises,
    and nothing falls back to running the function eagerly."""
    from marl_traffic_intersection_tpu_torch.utils.graphs import Graph, GraphPool
    x = torch.ones(8, device=card)
    graph = Graph(lambda: float(x.sum()), GraphPool(card))
    with pytest.raises(RuntimeError):
        graph()
    assert graph.graph is None


def test_a_capture_holds_off_the_cyclic_collector(card):
    """The warm-up runs with Python's cyclic collector on, the capture with
    it off, and it is on again after: a collection inside a capture could
    destroy a dead graph, which CUDA forbids while a stream captures."""
    import gc

    from marl_traffic_intersection_tpu_torch.utils.graphs import Graph, GraphPool
    x, seen = torch.zeros(4, device=card), []

    def fn():
        seen.append(gc.isenabled())
        return x + 1
    graph = Graph(fn, GraphPool(card))
    graph()
    graph()
    assert seen == [True, False] and gc.isenabled() and graph.replays == 1


def _packed_fleet(B, M, dev, rng, grid=False):
    """An NPC pool with 20 NPCs in env 0 (the full width of 32 slots) and a
    pair at one pose in env 1. Packed about the centre, two of env 0's at
    one pose, the first step replays dependent slots and runs the cascade;
    on a grid 70 px apart (``grid``) none overlaps, so all 20 stay."""
    from marl_traffic_intersection_tpu_torch.core.npc import NpcState
    alive = np.zeros((B, M), bool)
    alive[0, :20] = alive[1, :2] = True
    x = rng.uniform(320, 430, (B, M)).astype(np.float32)
    y = rng.uniform(320, 430, (B, M)).astype(np.float32)
    if grid:
        x[0, :20], y[0, :20] = 60 + 70 * (np.arange(20) % 10), 250 + 250 * (np.arange(20) // 10)
    else:
        x[0, 1], y[0, 1] = x[0, 0], y[0, 0]
    x[1, 1], y[1, 1] = x[1, 0], y[1, 0]
    t = lambda a, d=np.float32: torch.from_numpy(a.astype(d)).to(dev)
    return NpcState(alive=t(alive, bool), x=t(x), y=t(y), v=t(rng.uniform(0, 8, (B, M))),
                    heading=t(rng.uniform(-np.pi, np.pi, (B, M))),
                    steering_angle=t(np.zeros((B, M))),
                    route_id=t(rng.randint(0, 12, (B, M)), np.int32),
                    path_index=t(rng.randint(0, 160, (B, M)), np.int32),
                    uid=t(np.tile(np.arange(M), (B, 1)), np.int32),
                    next_uid=t(np.full(B, M), np.int32))


def _traffic_venv(card, B, mode, cleanup="slot", p_try=1.0, max_steps=30):
    """Config 4 (8 agents, 32 NPC slots) at B envs with seeded spawn tries."""
    import marl_traffic_intersection_tpu_torch as P
    env = P.IntersectionEnv(P.EnvConfig(num_agents=8, traffic_flow=True, npc_mode=mode,
                                        npc_cleanup=cleanup, max_steps=max_steps), device=card)
    srng, T = np.random.RandomState(6), env.traffic_ids.shape[0]

    def spawns(k):
        return (torch.from_numpy(srng.uniform(size=k) < p_try).to(card),
                torch.from_numpy(srng.randint(T, size=k).astype(np.int32)).to(card))
    return P.VectorEnv(env, num_envs=B, seed=3, spawn_sampler=spawns)


def _host(tree):
    from marl_traffic_intersection_tpu_torch.utils.graphs import leaves
    return [x.cpu() for x in leaves(tree)]


def _assert_host_bits(a, b, where):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y), (where, i)


@pytest.mark.parametrize("mode,cleanup", [("exact", "slot"), ("exact", "wave"),
                                          ("fast", "slot"), ("serial", "slot")])
def test_graphed_traffic_step_equals_the_eager_step(card, mode, cleanup):
    """VectorEnv.jit_step() with traffic, the segments of the step replayed
    as CUDA graphs between the host's reads: bit-equal to ``step`` over 50
    steps at 64 x 8 (a packed fleet injected at the start, a spawn try
    every step, resets at step 30, both final_obs), with equal npc_stats;
    the exact mode's cleanup and cascade must have run rounds."""
    runs, stats = [], []
    for graphed in (False, True):
        venv = _traffic_venv(card, 64, mode, cleanup)
        step = venv.jit_step() if graphed else venv.step
        state, _ = venv.reset()
        state = state._replace(npc=_packed_fleet(64, 32, card, np.random.RandomState(9)))
        rng, hist = np.random.RandomState(8), []
        for t in range(50):
            a = np.stack([rng.uniform(0.2, 1.0, (64, 8)), rng.uniform(-0.2, 0.2, (64, 8))], -1)
            state, *rest = step(state, torch.from_numpy(a.astype(np.float32)).to(card),
                                final_obs=t % 4 == 0)
            hist.append(_host((state, rest)))
        runs.append(hist)
        stats.append(stat_counts(venv.env.npc_stats))
    for t, (a, b) in enumerate(zip(*runs)):
        _assert_host_bits(a, b, f"step {t}")
    assert stats[0] == stats[1], stats
    widths = [k for k in stats[0] if k.startswith("step_width_")]
    assert len(widths) >= 2, stats[0]
    if mode == "exact":
        assert stats[0]["cleanup_rounds"] > 0 and stats[0]["collision_rounds"] > 0, stats[0]


def test_graphed_traffic_step_replays_a_width_captured_before_a_switch(card):
    """Widths 8 -> 32 -> 8: five steps from a fresh reset (w = 8), five from
    a state with 20 NPCs on a grid (the full 32), five from a fresh reset
    again, whose steps replay the w = 8 segments captured first (the graphs
    of all widths share one pool): bit-equal to the eager step fed the same
    states."""
    runs = []
    for graphed in (False, True):
        venv = _traffic_venv(card, 64, "exact", p_try=0.3)
        step = venv.jit_step() if graphed else venv.step
        rng, hist, widths = np.random.RandomState(4), [], []
        for leg in range(3):
            state, _ = venv.reset()
            if leg == 1:
                state = state._replace(npc=_packed_fleet(64, 32, card, np.random.RandomState(2),
                                                         grid=True))
            if graphed and leg == 2:
                replays = step.graphs[("step", 8, False)].replays
            for _ in range(5):
                before = dict(venv.env.npc_stats)
                a = np.stack([rng.uniform(0.2, 1.0, (64, 8)),
                              rng.uniform(-0.2, 0.2, (64, 8))], -1).astype(np.float32)
                state, out = step(state, torch.from_numpy(a).to(card))
                hist.append(_host((state, out)))
                widths += [k for k, v in venv.env.npc_stats.items()
                           if k.startswith("step_width_") and v > before.get(k, 0)]
        assert widths == ["step_width_8"] * 5 + ["step_width_32"] * 5 + ["step_width_8"] * 5
        runs.append(hist)
    assert step.graphs[("step", 8, False)].replays >= replays + 5
    assert step.graphs[(8, "npc begin")].replays >= 9
    for t, (a, b) in enumerate(zip(*runs)):
        _assert_host_bits(a, b, f"step {t}")


def test_graphed_traffic_step_times_the_device_idle_after_each_read(card):
    """30 exact steps at 64 x 8 (the packed fleet, a spawn try every step),
    eager then graphed: the graphed run keeps a span for each of the three
    read causes (the width, the cleanup's, the cascade's), each >= 0 and
    together below the run's host wall time; the eager run keeps none, and
    the counts of the two runs are equal."""
    import time

    from marl_traffic_intersection_tpu_torch.utils.graphs import IDLE

    runs = []
    for graphed in (False, True):
        venv = _traffic_venv(card, 64, "exact")
        step = venv.jit_step() if graphed else venv.step
        state, _ = venv.reset()
        state = state._replace(npc=_packed_fleet(64, 32, card, np.random.RandomState(9)))
        rng = np.random.RandomState(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            a = np.stack([rng.uniform(0.2, 1.0, (64, 8)), rng.uniform(-0.2, 0.2, (64, 8))], -1)
            state, _ = step(state, torch.from_numpy(a.astype(np.float32)).to(card))
        torch.cuda.synchronize()
        runs.append((dict(venv.env.npc_stats), time.perf_counter() - t0))
    (eager, _), (stats, wall_s) = runs
    idle = {k: v for k, v in stats.items() if k.startswith(IDLE)}
    assert sorted(idle) == sorted(IDLE + c for c in ("width", "cleanup", "cascade")), stats
    assert all(v >= 0 for v in idle.values()) and sum(idle.values()) < wall_s, (idle, wall_s)
    assert stat_counts(stats) == eager and not any(k.startswith(IDLE) for k in eager)


def test_a_segment_that_reads_the_host_raises(card):
    """A segment whose function reads the device from the host cannot be
    captured: ``Segments`` raises, and nothing runs it eagerly instead."""
    from marl_traffic_intersection_tpu_torch.utils.graphs import GraphPool, Segments
    segs = Segments(GraphPool(card))
    x = torch.ones(8, device=card)
    with pytest.raises(RuntimeError):
        segs.carry(("read",), lambda t: t * float(t.sum()), x)
    assert segs.graphs[("read",)].graph is None
