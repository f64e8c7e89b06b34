"""The traffic generator: the same seed gives the same inputs."""
import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.tests.helpers import CELLS, tiny

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


def _inputs(name, seed, envs=64):
    cell = tiny(name, envs=envs)
    cell.traffic = dict(cell.traffic, check=dict(steps=3, horizon=50, envs=16))
    return traffic.make_inputs(cell.traffic, envs, cell.config["num_agents"], 2000,
                               np.arange(12, dtype=np.int32), 8, seed, "cpu")


def _leaves(inp):
    out = [inp.actions, inp.routes.bank, torch.as_tensor(inp.check_rows),
           torch.as_tensor(inp.check_steps)]
    if inp.spawns is not None:
        out += list(inp.spawns.bank)
    if inp.step_count is not None:
        out.append(inp.step_count)
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(name, seed):
    a, b = _inputs(name, seed), _inputs(name, seed)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    c = _inputs(name, seed + 1)
    assert not torch.equal(a.actions, c.actions)


@pytest.mark.parametrize("seed", SEEDS)
def test_spawns_follow_the_reference_law_and_phases_cover_every_step(seed):
    inp = _inputs("cfg4-traffic-d1-4096x8", seed, envs=4096)
    do_try, choice = inp.spawns.bank
    p = float(np.float32(1.0) - np.exp(-np.float32(1.0) * np.float32(1 / 60)))
    tries = do_try.sum(1).double()
    # a Bernoulli(p) try per env and step: binomial counts, not a fixed one
    assert abs(float(tries.mean()) - p * 4096) < 4 * (p * 4096 / do_try.shape[0]) ** 0.5
    assert float(tries.std()) > 0.5 * (p * (1 - p) * 4096) ** 0.5
    counts = torch.bincount(choice.reshape(-1).long(), minlength=8)
    assert choice.min() >= 0 and choice.max() < 8
    assert float(counts.min()) > 0.9 * float(counts.float().mean())   # uniform routes
    routes = inp.routes.bank
    assert routes.shape == (61, 4096, 8)
    assert bool((routes.sort(-1).values.diff(dim=-1) != 0).all())   # no route twice in an env
    # every phase below max_steps is held by 2 or 3 envs: each step ends as many episodes
    phases = torch.bincount(inp.step_count.long(), minlength=2000)
    assert phases.shape == (2000,) and int(phases.min()) == 2 and int(phases.max()) == 3


def test_sampler_cycles_its_bank_and_records_the_entry():
    s = traffic.Sampler(torch.arange(3 * 4).reshape(3, 4))
    got = [s(4)[0].item() for _ in range(5)]
    assert got == [0, 4, 8, 0, 4] and s.last == 1
    with pytest.raises(ValueError):
        s(5)


def test_a_traffic_file_with_a_stray_key_is_refused():
    cell = tiny("cfg5-rollout-4096x4")
    with pytest.raises(ValueError):
        traffic.validate(dict(cell.traffic, burst=3))
