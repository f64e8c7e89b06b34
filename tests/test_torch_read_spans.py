"""The host's device reads timed on the segment runner, and the exact NPC
update's per-tick round histogram, on the CPU.

A read (``utils.graphs.host_read``) opens a span on the graphed runner
(``utils/graphs.py::Segments``) and the next replay closes it into
``npc_stats["read_idle_s.<cause>"]``; the eager runner keeps no span. Here
the graphs are re-runs of their functions (tests/test_torch_graphs.py's
``rerun_graphs``) and the clock is injected, so each span's length is
known. The traffic runs hold the histogram ``npc_rounds_at_<n>`` to the
ticks and to the loops' rounds, and the counts of an eager run to those of
a graphed one. The card's side is in tests/test_torch_cuda.py.
"""
import collections

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch import VectorEnv
from marl_traffic_intersection_tpu_torch.core.constants import DT_DEFAULT
from marl_traffic_intersection_tpu_torch.envs import vector as vector_module
from marl_traffic_intersection_tpu_torch.utils import graphs
from marl_traffic_intersection_tpu_torch.utils.graphs import EAGER, IDLE, host_read, stat_counts

from ._torch_port import port_env
from .test_torch_graphs import _Pool, rerun_graphs  # noqa: F401 (a fixture)
from .test_torch_graphs_traffic import B, N, SLOTS, _fleet, _forward, _spawns

CAUSES = ("width", "cleanup", "cascade")


class _Clock:
    """A clock in ns that the test sets (``ns``), or that moves by ``tick``
    at each reading."""

    def __init__(self, tick: int = 0):
        self.ns, self.tick = 0, tick

    def __call__(self) -> int:
        self.ns += self.tick
        return self.ns


def test_a_read_then_a_replay_adds_the_gap_under_its_cause(rerun_graphs):
    stats, clock = collections.Counter(), _Clock()
    seg = graphs.Segments(_Pool("cpu"), stats, clock)
    x = torch.zeros(2)
    seg(("a",), torch.neg, x)                       # the key's warm-up and capture
    clock.ns = 1_000
    assert host_read(seg, "width", lambda: 7) == 7
    clock.ns = 3_500
    seg(("a",), torch.neg, x)
    assert stats == {IDLE + "width": pytest.approx(2.5e-6)}
    clock.ns = 9_000
    seg(("a",), torch.neg, x)                       # no read before it: nothing added
    host_read(seg, "cleanup", lambda: 0)
    clock.ns = 9_400
    seg.carry(("a", "carried"), torch.neg, x)       # a first call drops the open span
    seg(("a",), torch.neg, x)
    assert stats == {IDLE + "width": pytest.approx(2.5e-6)}
    host_read(seg, "cascade", lambda: 0)
    clock.ns = 10_000
    seg.carry(("a", "carried"), torch.neg, x)
    assert stats == {IDLE + "width": pytest.approx(2.5e-6),
                     IDLE + "cascade": pytest.approx(6e-7)}


def test_a_read_then_an_eager_call_adds_nothing(rerun_graphs):
    """A read on the eager runner opens no span, so the next replay adds
    nothing; a runner without a counter keeps no span either."""
    stats, x = collections.Counter(), torch.zeros(2)
    seg = graphs.Segments(_Pool("cpu"), stats, _Clock(tick=1_000))
    seg(("a",), torch.neg, x)
    assert host_read(EAGER, "width", lambda: 3) == 3
    assert torch.equal(EAGER(("a",), torch.neg, x), -x)
    seg(("a",), torch.neg, x)
    assert not stats
    bare = graphs.Segments(_Pool("cpu"), clock=_Clock(tick=1_000))
    bare(("a",), torch.neg, x)
    host_read(bare, "cleanup", lambda: 1)
    bare(("a",), torch.neg, x)
    assert bare._read is None


@pytest.mark.parametrize("cleanup", ["slot", "wave"])
def test_the_histogram_sums_to_the_ticks_and_the_spans_to_the_reads(rerun_graphs, cleanup):
    """20 exact steps at 8 x 2 (the fleet of tests/test_torch_graphs_traffic.py,
    so the loops run rounds), eager and graphed: the counts equal, the
    histogram's counts sum to the ticks and its rounds to the loops' rounds;
    only the graphed run keeps spans, one for each of the three causes, and,
    the clock moving 1 us a reading, each span is 1 us and at most one
    follows each read (a read before a key's first call keeps none)."""
    steps = 20

    def make():
        env = port_env(N, traffic_flow=True, max_npcs=SLOTS, max_steps=12, npc_mode="exact",
                       npc_cleanup=cleanup)
        return VectorEnv(env, num_envs=B, seed=6,
                         spawn_sampler=_spawns(7, env.traffic_ids.shape[0]))

    ev, gv = make(), make()
    fleet = _fleet(ev.env, np.random.RandomState(5))
    se, _ = ev.reset()
    sg, _ = gv.reset()
    se, sg = se._replace(npc=fleet), sg._replace(npc=graphs.clone_tree(fleet))
    step = vector_module._GraphedStep(gv, DT_DEFAULT, donate=True)
    step.segments.clock = _Clock(tick=1_000)
    rng = np.random.RandomState(8)
    for _ in range(steps):
        a = _forward(rng)
        se = ev.step(se, a)[0]
        sg = step(sg, a)[0]
    e, g = ev.env.npc_stats, gv.env.npc_stats
    assert stat_counts(g) == e and not any(k.startswith(IDLE) for k in e), (e, g)
    hist = {int(k[len("npc_rounds_at_"):]): v for k, v in e.items()
            if k.startswith("npc_rounds_at_")}
    assert sum(hist.values()) == steps, hist
    assert sum(n * v for n, v in hist.items()) == e["cleanup_rounds"] + e["collision_rounds"]
    assert max(hist) >= 2 and e["cleanup_rounds"] and e["collision_rounds"], e
    reads = {"width": e["tier_reads"],
             "cleanup": steps + (e["cleanup_rounds"] if cleanup == "wave" else 0),
             "cascade": steps + e["collision_rounds"]}
    assert sum(reads.values()) == e["host_reads"]
    assert sorted(k for k in g if k.startswith(IDLE)) == sorted(IDLE + c for c in CAUSES), g
    for cause in CAUSES:
        spans = g[IDLE + cause] / 1e-6
        assert spans == pytest.approx(round(spans)), (cause, g)
        assert reads[cause] - len(step.graphs) <= round(spans) <= reads[cause], (cause, g)
