"""Process-group workers for the port's distributed tests.

Each function runs in every rank of a group that
``marl_traffic_intersection_tpu_torch.dryrun.spawn`` starts (gloo, on the
CPU), and rank 0 writes what the test reads to ``out`` with ``torch.save``.
This module imports neither JAX nor the JAX package, so the ranks start
quickly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from marl_traffic_intersection_tpu_torch.core.env import EnvConfig, IntersectionEnv
from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.parallel.mesh import (
    full_state_dicts, gather_batch_tree, make_mesh, shard_batch_tree, tree_map)
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner, read_metrics
from marl_traffic_intersection_tpu_torch.parallel.recurrent_ppo import RecurrentPPOLearner
from marl_traffic_intersection_tpu_torch.parallel.sac import SACConfig, SACLearner
from marl_traffic_intersection_tpu_torch.utils.profiling import collective_census

F32 = dict(compute_dtype=torch.float32)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _bit_diffs(a, b) -> list:
    """Indices of the leaves of two trees that differ bit for bit."""
    return [i for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b)))
            if x.shape != y.shape or not torch.equal(
                x.view(torch.uint8) if x.dtype.is_floating_point else x,
                y.view(torch.uint8) if y.dtype.is_floating_point else y)]


# ---------------------------------------------------------------- env steps
TRAFFIC = dict(num_agents=2, traffic_flow=True, traffic_density=4.0, max_npcs=12,
               max_steps=10 ** 6)


def env_world_vs_one(dev, out: str, num_envs: int = 16, steps: int = 60) -> None:
    """VectorEnv with traffic on a (world, 1) mesh against one process
    stepping the global batch: per step, the leaves of the gathered state
    and step output that differ bit for bit, and each rank's NPC width."""
    mesh = make_mesh(dist.get_world_size(), 1)
    venv = VectorEnv(IntersectionEnv(EnvConfig(**TRAFFIC), device=dev), num_envs, seed=3)
    state, obs = venv.reset()
    bound = venv.with_mesh(mesh)
    state, obs = shard_batch_tree(mesh, (state, obs))
    rank0 = dist.get_rank() == 0
    if rank0:
        one = VectorEnv(IntersectionEnv(EnvConfig(**TRAFFIC), device=dev), num_envs, seed=3)
        state1, obs1 = one.reset()
    rng = np.random.RandomState(9)
    stats = bound.env.npc_stats
    diffs, widths = [], []
    for _ in range(steps):
        acts = torch.as_tensor(rng.uniform(-1, 1, (num_envs, 2, 2)), dtype=torch.float32)
        before = dict(stats)
        state, o = bound.step(state, acts[bound.rows])
        widths.append(next(int(k.rsplit("_", 1)[1]) for k in stats
                           if k.startswith("step_width_") and stats[k] != before.get(k, 0)))
        whole = gather_batch_tree(mesh, (state, o))
        if rank0:
            state1, o1 = one.step(state1, acts)
            diffs.append(_bit_diffs(whole, (state1, o1)))
    all_widths = [None] * dist.get_world_size()
    dist.all_gather_object(all_widths, widths)
    if rank0:
        torch.save({"diffs": diffs, "widths": all_widths,
                    "npcs": int(whole[0].npc.alive.sum())}, out)


# ----------------------------------------------------------------- learners
def _full(ts, mesh):
    model, opt = full_state_dicts(ts.model, ts.optimizer, mesh)
    return model, opt["state"]


def _single_full(ts):
    return ts.model.state_dict(), ts.optimizer.state_dict()["state"]


def ppo_world_vs_one(dev, out: str, kind: str, tp: int, num_envs: int = 8) -> None:
    """One float32 PPO (recurrent PPO for 'gru') train step on a (world //
    tp, tp) mesh and in one process on the global batch, from the same
    seeds: both runs' whole parameters, Adam moments and logged metrics."""
    world = dist.get_world_size()
    mesh = make_mesh(world // tp, tp)
    cfg = PPOConfig(rollout_len=8, num_minibatches=2, update_epochs=2)
    cls = RecurrentPPOLearner if kind == "gru" else PPOLearner

    def learner():
        venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=2), device=dev), num_envs, seed=3)
        lrn = cls(venv, make_model(kind, seed=5, **F32), cfg, seed=4)
        carry = list(venv.reset()) + ([lrn.initial_hidden()] if kind == "gru" else [])
        return lrn, lrn.init(), carry

    lrn, ts, carry = learner()
    step, shard_ts, shard_env = lrn.distributed(mesh, kind)
    ts = shard_ts(ts)
    ts, *carry, metrics = step(ts, *shard_env(*carry))
    got = {"metrics": read_metrics(metrics, mesh), "state": _full(ts, mesh),
           "carry": _leaves(gather_batch_tree(mesh, carry)), "update_count": ts.update_count}
    if dist.get_rank() == 0:
        lrn1, ts1, carry1 = learner()
        ts1, *carry1, metrics1 = lrn1.train_step(ts1, *carry1)
        want = {"metrics": read_metrics(metrics1), "state": _single_full(ts1),
                "carry": _leaves(carry1), "update_count": ts1.update_count}
        torch.save({"got": got, "want": want}, out)


def sac_world_vs_one(dev, out: str, tp: int, num_envs: int = 8) -> None:
    """One float32 SAC train call (4 env steps and updates) on a (world //
    tp, tp) mesh and in one process; both runs' whole parameters and
    metrics, and the assembled sample of 64 fixed global indices against
    the whole ring (gathered from the ranks) at those indices."""
    from marl_traffic_intersection_tpu_torch.models.sac import TwinQCritic
    from marl_traffic_intersection_tpu_torch.parallel.mesh import full_tensor

    world = dist.get_world_size()
    mesh = make_mesh(world // tp, tp)
    cfg = SACConfig(batch_size=32, buffer_capacity=256, warmup=16, steps_per_call=4)

    def learner():
        venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=2), device=dev), num_envs, seed=3)
        actor = make_model("sac", seed=5, **F32)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(6)
            critic = TwinQCritic(**F32)
        lrn = SACLearner(venv, cfg, actor, critic, seed=4)
        return lrn, lrn.init(), venv.reset()

    def whole(ts, gather):
        nets = {}
        for name, net in (("actor", ts.actor), ("critic", ts.critic),
                          ("target", ts.critic_target)):
            nets[name] = {k: gather(p.detach(), getattr(p, "tp_dim", None))
                          for k, p in net.named_parameters()}
        nets["log_alpha"] = ts.log_alpha.detach().clone()
        return nets

    lrn, ts, carry = learner()
    step, shard_ts, shard_env = lrn.distributed(mesh)
    ts = shard_ts(ts)
    ts, state, obs, metrics = step(ts, *shard_env(*carry))
    got = {"metrics": read_metrics(metrics, mesh), "nets": whole(
        ts, lambda v, d: full_tensor(v, d, mesh))}
    # the ring put back together slot by slot, and a sample at fixed indices
    buf = ts.buffer
    n_slots = lrn.capacity // lrn.chunk
    ring = [gather_batch_tree(mesh, x.reshape(n_slots, lrn.local_chunk, -1).transpose(0, 1)
                              ).transpose(0, 1).reshape(lrn.capacity, *x.shape[1:])
            for x in (buf.obs, buf.action, buf.reward, buf.next_obs, buf.done)]
    idx = torch.as_tensor(np.random.RandomState(2).randint(0, int(buf.size), 64))
    lrn.index_fn = lambda n, size: idx
    sample = lrn._sample(buf, 64)
    if dist.get_rank() == 0:
        lrn1, ts1, carry1 = learner()
        ts1, _, _, metrics1 = lrn1.train_step(ts1, *carry1)
        want = {"metrics": read_metrics(metrics1), "nets": whole(ts1, lambda v, d: v)}
        torch.save({"got": got, "want": want, "sample": sample,
                    "ring_at": tuple(x[idx] for x in ring)}, out)


# ------------------------------------------------------------ tensor parallel
def tp_forwards(dev, out: str, weights: str) -> None:
    """Every family of ``weights`` (a torch.save of {kind: (state dict,
    inputs)}) split over a (1, world) mesh, its float32 forward on the
    inputs; with 4 ranks also the hybrid meshes' shapes and the data shards'
    round trip."""
    import os

    from marl_traffic_intersection_tpu_torch.models.sac import TwinQCritic
    from marl_traffic_intersection_tpu_torch.parallel.mesh import (
        data_axis, make_hybrid_mesh, shard_model_)

    world = dist.get_world_size()
    mesh = make_mesh(1, world)
    results = {}
    for kind, (state, inputs) in torch.load(weights).items():
        net = TwinQCritic(**F32) if kind == "sac_q" else make_model(kind, **F32)
        net.load_state_dict(state)
        shard_model_(net, kind, mesh)
        with torch.no_grad():
            results[kind] = net(*inputs)
    if world == 4:
        batch = {"x": torch.arange(24.0).reshape(8, 3), "b": torch.arange(8) % 3 == 0}
        meshes = {"2d": make_mesh(2, 2), "one node": make_hybrid_mesh(2)}
        os.environ["LOCAL_WORLD_SIZE"] = "2"        # as torchrun sets it on two nodes
        meshes["two nodes"] = make_hybrid_mesh(2)
        del os.environ["LOCAL_WORLD_SIZE"]
        for name, m in meshes.items():
            back = gather_batch_tree(m, shard_batch_tree(m, batch))
            ranks, data = [None] * world, data_axis(m)
            dist.all_gather_object(ranks, (data.rank, data.size))
            results[name] = {"shape": tuple(m.shape), "dims": m.mesh_dim_names,
                             "round_trip": all(torch.equal(back[k], batch[k]) for k in batch),
                             "data": ranks}
    if dist.get_rank() == 0:
        torch.save(results, out)


# ------------------------------------------------------------------ census
ENVS_PER_RANK = 16
CENSUS_PPO = PPOConfig(rollout_len=8)              # 4 epochs x 4 minibatches
CENSUS_SAC = SACConfig(batch_size=32, buffer_capacity=512, warmup=16, steps_per_call=2)


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def census(dev, out: str) -> None:
    """The collectives each rank issues (utils/profiling.py::
    collective_census) in an env step with and without traffic on a (world,
    1) mesh, ENVS_PER_RANK envs a rank, with the aten ops of the no-traffic
    step; in one PPO train step (CENSUS_PPO, the MLP) on every (dp, tp) mesh
    of the world with tp <= 2, with the layers the model split tagged; in
    one SAC train call (CENSUS_SAC) at (world, 1); and in ``read_metrics``.
    Rank 0 writes every rank's lists."""
    world = dist.get_world_size()
    meshes = {tp: make_mesh(world // tp, tp) for tp in (1, 2) if world % tp == 0}
    res = {"world": world}
    with collective_census() as calls:
        for traffic in (False, True):
            cfg = EnvConfig(num_agents=2, max_steps=10 ** 9, traffic_flow=traffic,
                            traffic_density=1.0)
            venv = VectorEnv(IntersectionEnv(cfg, device=dev), ENVS_PER_RANK * world,
                             seed=0).with_mesh(meshes[1])
            state, _ = venv.reset()
            zeros = torch.zeros((ENVS_PER_RANK, 2, 2))
            n0, ops = len(calls), []
            for _ in range(3):
                with OpCount() as count:
                    state, step_out = venv.step(state, zeros)
                ops.append(count.n)
            res[f"env traffic={traffic}"] = {"calls": calls[n0:], "ops": ops}

        for tp, mesh in meshes.items():
            dp = world // tp
            venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=2), device=dev),
                             ENVS_PER_RANK * dp, seed=3)
            lrn = PPOLearner(venv, make_model("mlp", seed=5, **F32), CENSUS_PPO, seed=4)
            ts, carry = lrn.init(), venv.reset()
            step, shard_ts, shard_env = lrn.distributed(mesh, "mlp")
            ts = shard_ts(ts)
            roles = [m.tp_role.kind for m in ts.model.modules() if hasattr(m, "tp_role")]
            n0 = len(calls)
            ts, *_, metrics = step(ts, *shard_env(*carry))
            n1 = len(calls)
            read_metrics(metrics, mesh)
            res[f"ppo dp={dp} tp={tp}"] = {"calls": calls[n0:n1], "read_metrics": calls[n1:],
                                           "roles": roles,
                                           "params": sum(p.numel() for p in ts.model.parameters())}

        venv = VectorEnv(IntersectionEnv(EnvConfig(num_agents=2), device=dev),
                         ENVS_PER_RANK * world, seed=3)
        lrn = SACLearner(venv, CENSUS_SAC, seed=4)
        step, shard_ts, shard_env = lrn.distributed(meshes[1])
        ts = shard_ts(lrn.init())
        n0 = len(calls)
        ts, *_, metrics = step(ts, *shard_env(*venv.reset()))
        n1 = len(calls)
        read_metrics(metrics, meshes[1])
        res["sac"] = {"calls": calls[n0:n1], "read_metrics": calls[n1:]}
    ranks = [None] * world
    dist.all_gather_object(ranks, res)
    if dist.get_rank() == 0:
        torch.save(ranks, out)
