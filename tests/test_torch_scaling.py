"""The port's collective census: the counterpart of tests/test_scaling.py.

The JAX package reads its collectives from the compiled program's text; the
port issues each one as a ``torch.distributed`` call, so the census wraps
those calls (utils/profiling.py::collective_census) in every rank of a gloo
group of 1, 2 and 4 processes on the CPU (one spawn per world size, every
check in it: tests/_torch_dist.py::census) and asserts:

  * the env step issues no collective, with and without traffic, on a mesh
    of any size, and each rank dispatches as many aten ops per no-traffic
    step at world 1, 2 and 4 (ENVS_PER_RANK envs a rank): the work per
    rank does not grow with the world, as JAX's per-device FLOPs and bytes;
  * a PPO train step (the MLP, 4 epochs x 4 minibatches) issues none at
    world 1, as XLA drops a psum over a size-1 axis; at dp > 1 two scalar
    all-reduces per minibatch (the advantage statistics) and one gradient
    all-reduce of the rank's parameters; at tp > 1 also the global norm's
    scalar all-reduce per minibatch and the row layer's all-reduce in
    every forward (models/tp.py; below); never an all-gather, so nothing
    the size of the rollout crosses ranks;
  * a SAC update issues none at world 1 and exactly one all-gather of
    ``world x batch_size`` rows above it;
  * ``read_metrics`` issues none at world 1 and one all-reduce above it.

models/tp.py's collectives are reached only through the layers
``shard_model_`` tags; at tp == 1 no layer is tagged, so ``_all_reduce``
and ``_all_gather`` are never called there.
"""
import ast
import os

import pytest
import torch

import marl_traffic_intersection_tpu_torch as port
from marl_traffic_intersection_tpu_torch.dryrun import spawn
from marl_traffic_intersection_tpu_torch.utils.profiling import COLLECTIVES

from . import _torch_dist
from . import _torch_port  # noqa: F401  (one torch thread per test worker)
from ._torch_dist import CENSUS_PPO, CENSUS_SAC, ENVS_PER_RANK

# torch.distributed's functions that move tensors between ranks
TORCH_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
                     "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather",
                     "scatter", "send", "recv", "isend", "irecv"}
WORLDS = (1, 2, 4)
AGENTS = 2
SAC_ROW = 127 + 2 + 1 + 127 + 1          # obs, action, reward, next obs, done
MESHES = [(1, 1), (2, 1), (4, 1), (2, 2)]


def _sources():
    root = os.path.dirname(port.__file__)
    for top, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(top, name)
    yield os.path.join(os.path.dirname(root), "chip_smoke.py")


def test_every_collective_is_looked_up_when_called():
    """The census wraps ``torch.distributed``'s attributes, so it sees every
    collective only if each call site looks its function up as
    ``dist.<name>`` when it runs: no module binds one at import time, and
    every one called is among the census' COLLECTIVES."""
    called = set()
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                    "torch.distributed"):
                bound = {a.name for a in node.names} & TORCH_COLLECTIVES
                assert not bound, f"{path}:{node.lineno} binds {bound} at import time"
            if isinstance(node, ast.Attribute) and node.attr in TORCH_COLLECTIVES and (
                    ast.unparse(node.value) in ("dist", "torch.distributed")):
                called.add(node.attr)
    assert called and called <= set(COLLECTIVES), called


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    out = {}
    for world in WORLDS:
        path = tmp_path_factory.mktemp(f"census{world}") / "census.pt"
        spawn(_torch_dist.census, world, (str(path),), timeout=240)
        out[world] = torch.load(path)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("traffic", [False, True])
def test_env_step_issues_no_collective(census, world, traffic):
    for rank in census[world]:
        assert rank["env traffic=%s" % traffic]["calls"] == []


def test_env_step_aten_ops_per_rank_do_not_grow_with_the_world(census):
    ops = {world: [r["env traffic=False"]["ops"] for r in census[world]] for world in WORLDS}
    print(f"aten ops per no-traffic step, {ENVS_PER_RANK} envs a rank: {ops}")
    # step by step (the first step dispatches a few ops more, at any world)
    assert min(ops[1][0]) > 0
    assert all(rank == ops[1][0] for world in WORLDS for rank in ops[world]), ops


def ppo_formula(dp: int, tp: int, rows: int, params: int) -> list:
    """The collectives of one PPO train step of the MLP on a (dp, tp) mesh,
    as (name, elements, group size) in order, from parallel/ppo.py,
    parallel/mesh.py and models/tp.py. The MLP's sharded forward has one
    row layer (torso.1, 256 -> 256): one float32 all-reduce of its (rows,
    256) partial sums per forward over the model axis, and none backwards,
    since its input is the column layer's output, already cut, and the
    column layer's input (the observation) needs no gradient. The rollout
    runs T + 1 forwards (one per step and the bootstrap value), each
    minibatch one more, on T / M of the steps. Per minibatch, in order: the
    forward's, the advantage statistics' two scalar sums (dp > 1), the
    gradient average of this rank's ``params`` (dp > 1), the global norm's
    scalar sum of the split parameters' squares (tp > 1)."""
    T, E, M = CENSUS_PPO.rollout_len, CENSUS_PPO.update_epochs, CENSUS_PPO.num_minibatches
    hidden = 256
    row = [("all_reduce", rows * hidden, tp)] if tp > 1 else []
    out = row * (T + 1)
    for _ in range(E * M):
        out += [("all_reduce", rows * hidden * T // M, tp)] if tp > 1 else []
        out += [("all_reduce", 1, dp)] * 2 + [("all_reduce", params, dp)] if dp > 1 else []
        out += [("all_reduce", 1, tp)] if tp > 1 else []
    return out


@pytest.mark.parametrize("dp,tp", MESHES)
def test_ppo_train_step_collectives(census, dp, tp):
    E, M = CENSUS_PPO.update_epochs, CENSUS_PPO.num_minibatches
    rows = ENVS_PER_RANK * AGENTS
    for r in census[dp * tp]:
        got = r[f"ppo dp={dp} tp={tp}"]
        calls = got["calls"]
        assert calls == ppo_formula(dp, tp, rows, got["params"]), calls[:8]
        assert got["roles"] == ([] if tp == 1 else ["column", "row"])
        if dp * tp == 1:
            assert calls == []
        if tp == 1 and dp > 1:
            # 32 scalar sums for the advantage statistics, 16 gradient averages
            assert sum(n == 1 for _, n, _ in calls) == 2 * E * M
            assert sum(n == got["params"] for _, n, _ in calls) == E * M == len(calls) - 2 * E * M
        # no all-gather, and nothing the size of the rollout's observations
        # (tests/test_scaling.py's "nothing batch-sized crosses devices")
        assert all(name == "all_reduce" for name, _, _ in calls)
        assert CENSUS_PPO.rollout_len * rows * 127 not in [n for _, n, _ in calls]
        assert [(name, ranks) for name, _, ranks in got["read_metrics"]] == \
            ([] if dp == 1 else [("all_reduce", dp)])


@pytest.mark.parametrize("world", WORLDS)
def test_sac_update_collectives(census, world):
    for r in census[world]:
        got = r["sac"]
        if world == 1:
            assert got["calls"] == [] and got["read_metrics"] == []
            continue
        want = ("all_gather", world * CENSUS_SAC.batch_size * SAC_ROW, world)
        assert got["calls"] == [want] * CENSUS_SAC.steps_per_call
        assert [name for name, _, _ in got["read_metrics"]] == ["all_reduce"]
