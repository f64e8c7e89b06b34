"""Run one cell of the port's benchmark once, and print its result line.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The system under test is marl_traffic_intersection_tpu_torch. The cell's
traffic file names the entry that the window calls (``entry``, by default
``env_step``), and the entry is found by that name among the files of
portbench/entries/: ``<name>.py`` exports its class as ``Entry``. The env
step's entry is ``EnvStep`` below (the program's batched env step with
auto-reset, replayed as CUDA graphs, ``VectorEnv.jit_step``), the PPO
learner's train step is portbench/learner.py's, and a later entry is a new
file there. ``run`` is the one shell of every run; an entry supplies only
its set-up, one window step, the steps or spans after the window, the check
and the end-to-end values. A run

  1. sets up: imports, loads the program's CUDA libraries (built into the
     checkout's ``marl_traffic_intersection_tpu_torch/_build/`` on a first
     run), and the entry's set-up: for the env step it builds the env,
     draws every input from ``--seed`` (portbench/traffic.py), resets,
     steps twice from a crowded copy of the state where the traffic file
     asks for one (``crowd``), and then the traffic file's ``warmup_steps``
     from the real state, which fill the NPC pool and capture the graphs;
  2. steps for ``--seconds`` (window.py);
  3. with ``--trace 1``, profiles a block of steps after the window and
     times the program's lidar op on a window step's poses (trace.py);
  4. frees the program and checks what the timed path produced against the
     plain reference (check.py for the env step);
  5. prints the result as its last line of standard output, after the
     card's name and power limit (read once the run is done, so that it
     costs the set-up nothing), the set-up's split and the check's
     seconds, with each number compared beside its limit also as the last
     lines of standard error.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (portbench/metrics/). The run
refuses to start without as many cards as the cell asks for, and prints
no result if the process holds JAX or the JAX package once it is done.
"""
from __future__ import annotations

import time

_T_MODULE = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "marl_traffic_intersection_tpu")
POST_WINDOW_S = 60.0        # how long a checked step may come after the window


def since_start() -> float:
    """Seconds since this process started (/proc/self/stat's start time;
    where that cannot be read, since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_MODULE


def foreign_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Splits:
    """The set-up's split: ``split(name)`` notes the seconds since the last
    call (or since it was made) under ``name`` in ``t``."""

    def __init__(self, t: dict):
        self.t, self.last = t, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.t[name] = now - self.last
        self.last = now


def entry_of(cell):
    """The entry class that the cell's traffic file names (``entry``; by
    default ``env_step``): ``Entry`` of ``portbench/entries/<entry>.py``
    under the cell's root. ValueError where no such file is there."""
    from . import spec
    return spec.entry(cell.traffic.get("entry", "env_step"), cell.root)


def graph_snapshot(step):
    """A copy of ``step.graphs`` (its graphs by name), or None where the step
    keeps none. The copy holds the graphs, so that a graph captured later
    is told from them by identity, whether the program hands out its live
    dict or builds a new one at each read."""
    graphs = getattr(step, "graphs", None)
    return None if graphs is None else dict(graphs)


def graph_counts(before, step) -> tuple:
    """(graphs at the window's start, that count plus the graphs that
    ``step.graphs`` holds now and ``before`` did not); (None, None) where
    the step keeps no graphs."""
    if before is None:
        return None, None
    known = {id(g) for g in before.values()}
    return len(before), len(before) + sum(id(g) not in known
                                          for g in graph_snapshot(step).values())


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell`` (spec.Cell); returns the result line's object and
    the notes printed before it. ``device="cpu"`` drives the same run
    without a card (the tests), timing steps on the host's clock."""
    t = {"before_run_s": since_start()}
    split = Splits(t)

    import torch

    from marl_traffic_intersection_tpu_torch.ops import native

    from . import window
    Entry = entry_of(cell)
    split("import_s")

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        for source in sorted(p.name for p in native.CSRC.glob("*.cu")):
            native.load(source)
    split("kernel_load_s")

    entry = Entry(cell, seed, dev, split)       # builds, draws, resets, warms up
    graphs = graph_snapshot(entry.step)
    capture_s = sum(gr.capture_s for gr in graphs.values()) if graphs is not None else None
    t["captures_s"] = capture_s
    clock = window.CudaClock(window.event_pool_size(entry.warm_rate, seconds)) if on_card \
        else window.HostClock()
    split("warmup_s")           # the captures included
    entry.opened()
    if on_card:
        torch.cuda.synchronize()
    setup_s = since_start()

    win = window.measure(entry.one, seconds, clock)

    peak = torch.cuda.max_memory_reserved(dev) if on_card else 0
    graphs_before, graphs_after = graph_counts(graphs, entry.step)
    entry.closed(win.steps, trace)
    profile = None
    if trace:
        from .trace import profile_block
        profile = profile_block(lambda _: entry.one(), entry.profile_steps)
    poses, pose_width = entry.poses, entry.pose_width
    entry.free()
    del graphs
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    lidar = lidar_readings(poses, pose_width, entry.env_cfg) \
        if trace and on_card and poses is not None else None

    t_check = time.perf_counter()
    readings, correct = entry.check()
    check_s = time.perf_counter() - t_check

    r = types.SimpleNamespace(steps=win.steps, wall_s=win.wall_s, graphs_before=graphs_before,
                              graphs_after=graphs_after, capture_s=capture_s, profile=profile,
                              lidar=lidar)
    vars(r).update(entry.reader_fields(profile))
    if trace:
        from . import spec
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = entry.end_to_end(win, peak, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": win.steps * entry.rows_per_step,
            "failed": int(readings["failed_env_steps"]), "metrics": metrics,
            "device": device_info}
    if profile is not None:
        device_info.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        line["breakdown"] = {"device_ops": profile["top_ops"],
                             "idle_gaps": profile["idle_gaps"]}
    line["checks"] = {name: {"value": readings[name], "limit": limit}
                      for name, limit in entry.LIMITS.items()}
    notes = {"setup_split": t, "setup_s": setup_s,
             "window": {"steps": win.steps, "wall_s": win.wall_s, **entry.window_notes(),
                        "graphs": [graphs_before, graphs_after],
                        "period_ms_p50_p95_p99_max": window.quantiles(win)},
             "check": {"seconds": check_s, **entry.check_notes(), "readings": readings}}
    if trace:
        notes["trace"] = {"lidar": lidar, **entry.trace_notes(), "profile": None
                          if profile is None else {key: profile[key] for key in (
                              "steps", "window_s", "device_ops", "device_s", "busy_s")}}
    return {"line": line, "notes": notes, "checked": entry.checked()}


class EnvStep:
    """The env step's entry (``VectorEnv.jit_step()``): set-up, one window
    step, the check, the end-to-end values. The run's shell is ``run``."""

    def __init__(self, cell, seed: int, dev, split):
        import torch

        from marl_traffic_intersection_tpu_torch.core.env import EnvConfig, IntersectionEnv
        from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv

        from . import check, traffic
        from .reference import vector as ref_vector

        self.on_card = on_card = dev.type == "cuda"
        self.tr = tr = traffic.validate(cell.traffic)
        self.env_cfg = env_cfg = cell.env_config()
        self.rows_per_step = B = cell.num_envs
        self.env = env = IntersectionEnv(EnvConfig(**env_cfg), device=dev)
        split("env_build_s")

        self.ref = ref = check.reference_env(env_cfg)
        self.inputs = inputs = traffic.make_inputs(
            tr, B, env.config.num_agents, env.config.max_steps, ref_vector.route_pool(ref),
            int(ref.traffic_ids.shape[0]), seed, dev)
        split("inputs_s")
        # what lives how long is as it always was, since the allocator's peak
        # depends on it: the reset's observation, the checked rows and the
        # crowded warm-up's real state live as long as the run, and no name
        # but ``self.state`` holds a state that the warm-up steps past
        self.venv = venv = VectorEnv(env, B, route_sampler=inputs.routes,
                                     spawn_sampler=inputs.spawns)
        self.step = venv.jit_step()
        self.state, self.obs = venv.reset()
        self.rows = rows = torch.as_tensor(inputs.check_rows, dtype=torch.long, device=dev)
        self.start = (check.take_rows(self.state, rows), self.obs.index_select(0, rows),
                      inputs.routes.entry(inputs.routes.last).index_select(0, rows).to("cpu"))
        if inputs.step_count is not None:
            self.state = self.state._replace(step_count=inputs.step_count.clone())
        self.rec = check.Recorder(inputs.check_steps, inputs.check_rows,
                                  tr["check"].get("busiest", 0), dev,
                                  tr["check"].get("ending", 0))
        if on_card:
            torch.cuda.synchronize()
        split("reset_s")

        self.g = 0                  # steps taken since the reset
        if tr["crowd"]:
            self.real, real_obs = check.clone(self.state), self.obs
            self.state = traffic.crowded(self.real, tr["crowd"], ref)
            for _ in range(2):
                self.one()
            self.state, self.obs = self.real, real_obs
            del real_obs
        half, t_half = tr["warmup_steps"] // 2, time.perf_counter()
        for i in range(tr["warmup_steps"]):
            if i == half:
                if on_card:
                    torch.cuda.synchronize()
                t_half = time.perf_counter()
            self.one()
        if on_card:
            torch.cuda.synchronize()
        self.warm_rate = (tr["warmup_steps"] - half) / max(time.perf_counter() - t_half, 1e-9)
        self.profile_steps = tr["profile_steps"]

    @property
    def LIMITS(self) -> dict:
        from .check import LIMITS
        return LIMITS

    def _widths(self) -> dict:
        return {name: n for name, n in self.env.npc_stats.items()
                if name.startswith("step_width_")}

    def act(self, k=None) -> tuple:
        """The step's actions, and what names them for the check (check.py's
        ``step_inputs``): their entry in the traffic's action bank."""
        i = self.g % self.inputs.actions.shape[0]
        return self.inputs.actions[i], i

    def observed(self, out) -> None:
        """What the step returned, for an entry that acts on it."""

    def one(self, k=None) -> None:
        """One step; ``k`` is its index in the window (None outside)."""
        rec, inputs = self.rec, self.inputs
        posed = k is not None and rec.full_poses is None and rec.pending(k)
        before = self._widths() if posed else None
        if k is not None:
            rec.before(k, self.state)
        actions, named = self.act(k)
        self.state, out = self.step(self.state, actions)
        if k is not None:
            rec.after(k, self.state, out, {
                "actions": named, "routes": inputs.routes.last,
                "spawns": inputs.spawns.last if inputs.spawns else None})
        self.observed(out)
        if posed and rec.full_poses is not None:
            # the NPC width the program stepped these poses at (its own counter)
            rec.pose_width = next((int(name[len("step_width_"):])
                                   for name, n in self._widths().items()
                                   if n > before.get(name, 0)), None)
        self.g += 1

    def opened(self) -> None:
        self.stats_before = dict(self.env.npc_stats)

    def closed(self, steps: int, trace: bool) -> None:
        """After the window: the counters' change, and the steps after it
        that the check still waits for."""
        self.stats = {k: v - self.stats_before.get(k, 0) for k, v in self.env.npc_stats.items()
                      if not k.endswith("_max")}
        k, t_post = steps, time.perf_counter()
        while not self.rec.done() and time.perf_counter() - t_post < POST_WINDOW_S:
            self.one(k)
            k += 1
        self.post_window_steps = k - steps

    @property
    def poses(self):
        return self.rec.full_poses

    @property
    def pose_width(self):
        return self.rec.pose_width

    def free(self) -> None:
        del self.step, self.venv, self.env, self.state

    def check(self) -> tuple:
        from . import check

        rec, inputs = self.rec, self.inputs
        if rec.done():
            readings = check.run_check(self.ref, rec, self.start, inputs)
        else:
            missing = sorted(set(inputs.check_steps) - set(rec.taken))
            readings = {**dict.fromkeys(check.LIMITS, -1), "steps": 0, "failed_env_steps": 0,
                        "episode_ends": 0, "never_came": missing}
        return readings, rec.done() and check.verdict(readings)

    def reader_fields(self, profile) -> dict:
        return {"num_envs": self.rows_per_step, "npc_stats": self.stats}

    def end_to_end(self, win, peak: int, setup_s: float) -> dict:
        from . import window
        return {"env_steps_per_s": window.env_steps_per_s(win, self.rows_per_step),
                "step_ms_p95": window.step_ms_p95(win), "peak_mem_mib": peak / 2 ** 20,
                "setup_s": setup_s}

    def window_notes(self) -> dict:
        return {"npc_stats": self.stats}

    def check_notes(self) -> dict:
        tr = self.tr
        return {"rows": len(self.inputs.check_rows) + tr["check"].get("ending", 0)
                + tr["check"].get("busiest", 0),
                "steps": self.inputs.check_steps, "post_window_steps": self.post_window_steps}

    def trace_notes(self) -> dict:
        return {}

    def checked(self) -> tuple:
        return (self.ref, self.rec, self.start, self.inputs)


def lidar_readings(poses, width, env_cfg: dict):
    """The lidar's least time on a window step's poses and the program's
    device time on them, in ms, with the operands that step scanned: every
    env row, the egos, and the first ``width`` NPC slots, the width the
    program stepped them at (None: every slot), as obstacles; None where the
    program has no lidar op to time."""
    import torch

    try:
        from marl_traffic_intersection_tpu_torch.ops.lidar_cuda import lidar_scan
    except ImportError:
        return None
    from . import roofline
    from .trace import lidar_ms

    operands = lidar_operands(poses, width)
    lanes = int(env_cfg.get("num_lanes", 3))
    device_ms = lidar_ms(lambda *a: lidar_scan(*a, num_lanes=lanes), operands)
    samples = roofline.lidar_samples(operands, lanes)
    B, N = operands[0].shape
    bound_s, by = roofline.lidar_bound_s(B, N, operands[3].shape[1], samples)
    return {"bound_ms": bound_s * 1e3, "device_ms": device_ms, "by": by, "samples": samples,
            "obstacles": int(operands[3].shape[1])}


def lidar_operands(poses, width) -> tuple:
    """The lidar's operands (sx, sy, sh, ox, oy, oh, om) of a step's poses
    (ego x, y, heading, NPC x, y, heading, alive): the egos scan, and the
    egos and the first ``width`` NPC slots (None: every slot) are the
    obstacles, as the program's step builds them at that width."""
    import torch

    x, y, h, *npc = poses
    nx, ny, nh, alive = (t[:, :width] for t in npc) if width is not None else npc
    ones = torch.ones_like(x, dtype=torch.bool)
    return (x, y, h, torch.cat([x, nx], 1), torch.cat([y, ny], 1),
            torch.cat([h, nh], 1), torch.cat([ones, alive], 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import spec
    cell = spec.load(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps({"card": card_line()}), flush=True)
    foreign = foreign_modules()
    if foreign:
        print(f"portbench: the process holds {foreign}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    print(json.dumps(result["notes"]), flush=True)
    for name, c in result["line"]["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
