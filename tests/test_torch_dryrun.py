"""``dryrun_multichip(4, "cpu")``: the port's counterpart of
tests/test_utils_entry.py::test_graft_dryrun_multichip, in 4 processes over
gloo. Every family at tp 1, 2 and 4, SAC, and the traffic families run one
sharded train step with finite losses."""
from marl_traffic_intersection_tpu_torch.dryrun import dryrun_multichip

from . import _torch_port  # noqa: F401  (one torch thread per test worker)


def test_dryrun_multichip_4_processes():
    lines = dryrun_multichip(4, "cpu", timeout=240)
    tps = [(4, 1), (2, 2), (1, 4)]
    want = [f"dryrun ok: {kind} dp={dp} tp={tp}"
            for kind in ("mlp", "attention", "conv", "gru", "central", "sac",
                         "mlp+traffic", "gru+traffic", "sac+traffic")
            for dp, tp in tps]
    assert lines == want
