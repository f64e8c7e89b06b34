"""A cell as BENCHMARK.json names it, and the files that belong to it.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:

  * a configuration: the ``file`` its entry names (portbench/configs/);
  * a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``entry``
    names what the window calls (by default ``env_step``);
  * an entry: ``portbench/entries/<entry>.py``, whose class ``Entry`` sets
    the cell up, takes one window step and checks what it produced (the env
    step, run.py's ``EnvStep``; the learner's train step, learner.py's
    ``TrainStep``; the env step with a trained policy acting,
    entries/policy_step.py);
  * a per-layer metric: ``portbench/metrics/<name>.py``, whose ``read(r)``
    takes the run's readings (run.py) and returns the value, or None when it
    finds nothing to read.

A cell reports the metrics whose ``workloads`` list it, or every metric
without that key.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
# keys of a configuration file that describe it and are not run
CONFIG_NOTES = {"assumed", "deployment", "notes"}
# keys of a configuration file that the env does not take: the batch, and
# the learner of a train-step cell (portbench/learner.py)
NOT_ENV = {"num_envs", "learner"}
# an entry's name: a Python identifier, so that it names a file of entries/ and nothing else
ENTRY_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file's object
    traffic: dict          # the traffic file's object
    end_to_end: list       # the metric entries this cell reports
    per_layer: list
    root: pathlib.Path = ROOT

    @property
    def num_envs(self) -> int:
        return int(self.config["num_envs"])

    def env_config(self) -> dict:
        """The configuration's keys that the env takes."""
        return {k: v for k, v in self.config.items()
                if k not in CONFIG_NOTES and k not in NOT_ENV}


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json and its files."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(workload, int(w["chips"]), cfg, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)], root)


def reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of the per-layer metric ``name``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def entry(name: str, root: pathlib.Path = ROOT):
    """The class ``Entry`` of ``portbench/entries/<name>.py`` under ``root``:
    the package's own module where ``root`` is this checkout's, else the
    file executed afresh as a module of the package's ``entries``, so that
    its relative imports reach the harness. ValueError where no such file
    is there."""
    path = pathlib.Path(root) / "portbench" / "entries" / f"{name}.py"
    if not isinstance(name, str) or not ENTRY_NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"traffic file: no entry {name!r}")
    if path.resolve() == (PKG / "entries" / f"{name}.py").resolve():
        return importlib.import_module(f"{__package__}.entries.{name}").Entry
    spec = importlib.util.spec_from_file_location(f"{__package__}.entries.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Entry
