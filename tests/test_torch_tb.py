"""``train --tb DIR`` (CPU): the event file holds every metric of the update
at each logged update, the scalars of the repo's train.py (train.py:330-332),
each equal to the JSON log line's value; and without ``--tb`` no TensorBoard
module is imported."""
import json
import os
import subprocess
import sys

import pytest

from marl_traffic_intersection_tpu_torch import train

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--num-envs", "4", "--agents", "2", "--rollout-len", "8",
         "--log-every", "1", "--updates", "2"]
# what train.py writes: the learner's metrics, not the timing keys and the
# labels (which step ran, the device) of the log line
NOT_SCALARS = ("update", "secs", "env_steps_per_s", "rollout_s", "update_s", "step", "device")


def test_tb_writes_every_metric_at_every_logged_update(tmp_path, capsys):
    event_accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    train.main(SMALL + ["--tb", str(tmp_path / "tb")])
    logs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"update"')]
    assert [ln["update"] for ln in logs] == [0, 1]
    acc = event_accumulator.EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    keys = sorted(k for k in logs[0] if k not in NOT_SCALARS)
    assert "pg_loss" in keys and sorted(acc.Tags()["scalars"]) == keys
    for k in keys:
        events = acc.Scalars(k)
        assert [e.step for e in events] == [0, 1], k
        for e, ln in zip(events, logs):
            # the log line rounds to 5 decimals
            assert abs(e.value - ln[k]) <= 5e-6 + 1e-6 * abs(ln[k]), (k, e.value, ln[k])


_NO_TB = """
import sys
from marl_traffic_intersection_tpu_torch import train
train.main(sys.argv[1:])
loaded = [m for m in sys.modules if "tensorboard" in m]
assert not loaded, loaded
print("ok")
"""


def test_no_tb_flag_imports_no_tensorboard():
    r = subprocess.run([sys.executable, "-c", _NO_TB, *SMALL], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
