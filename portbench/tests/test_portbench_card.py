"""The command's contract: without a card it prints no result and exits
non-zero; on the card (marked ``cuda``) each cell runs correct, its result
the last line of standard output and its numbers compared the last lines
of standard error."""
import json
import os
import subprocess

import pytest
import torch

from portbench import check, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _command(workload, seed, trace):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return bench["command"] + ["--workload", workload, "--seed", str(seed), "--seconds", "2",
                               "--trace", str(trace)]


def test_no_card_no_result(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cfg5-rollout-4096x4", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", ["cfg5-rollout-4096x4", "cfg4-traffic-d1-4096x8"])
def test_cell_runs_correct_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(_command(workload, 2 ** 31 + 17, trace), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = spec.load(workload)
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    assert list(line)[-1] == "checks"
    tail = out.stderr.strip().splitlines()[-len(check.LIMITS):]
    assert [t.split()[1] for t in tail] == list(check.LIMITS)
