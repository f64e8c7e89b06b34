"""The port's model families and Gaussian policy against the JAX package's.

``sample_action`` / ``logp_and_entropy`` are held against the JAX functions
on seeded means, log-stds at both bounds and pre-tanh samples beyond |10|,
with JAX's own normal draws fed in as the noise. The conv, attention and
central families run on parameters made by flax's ``init`` and carried over
by ``convert.py``.

Tolerances: float32 forwards agree within 1e-5 (the products sum in another
order). In bfloat16 the frameworks round at other places (flax rounds a
product to bf16 before adding the bias in bf16; torch adds the bias before
its one rounding; softmax and LayerNorm internals differ), so each layer may
part by a bf16 ulp (2^-8 relative). ``BF16_ATOL`` bounds the outputs of
these seeded inputs: means below 0.03 in magnitude, measured at most 2.5e-4
apart, within 1e-3; values below 2.3, where a bf16 ulp is 2^-7, measured at
most 2.5 ulps apart (0.0195, attention), within 0.04.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.models import make_model as jax_make_model
from marl_traffic_intersection_tpu.models.actor_critic import logp_and_entropy as jax_logp
from marl_traffic_intersection_tpu.models.actor_critic import sample_action as jax_sample
from marl_traffic_intersection_tpu_torch.convert import params_from_flax
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.models.actor_critic import logp_and_entropy, sample_action

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

F32_ATOL = 1e-5
BF16_ATOL = {"mean": 1e-3, "value": 0.04}


def _policy_inputs(seed=0, n=512):
    rng = np.random.RandomState(seed)
    mean = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    log_std = rng.uniform(-4.0, 0.5, (n, 2)).astype(np.float32)
    log_std[: n // 4] = -4.0                         # the bounds of bounded_log_std
    log_std[n // 4: n // 2] = 0.5
    raw = rng.normal(0, 3, (n, 2)).astype(np.float32)
    raw[::7] = rng.choice([-1, 1], (len(raw[::7]), 2)) * rng.uniform(10, 40, (len(raw[::7]), 2))
    return mean, log_std, raw


def test_logp_and_entropy_match_jax():
    """Within 2 f32 ulps (relative 2.4e-7) plus 1e-6 absolute of JAX's, on
    samples with |raw| up to 40, where the tanh correction's softplus must not
    switch to the identity early."""
    mean, log_std, raw = _policy_inputs()
    assert np.abs(raw).max() > 10
    jl, je = (np.asarray(a) for a in jax.jit(jax_logp)(mean, log_std, raw))
    pl, pe = (a.numpy() for a in logp_and_entropy(*map(torch.from_numpy, (mean, log_std, raw))))
    np.testing.assert_allclose(pl, jl, rtol=2.4e-7, atol=1e-6)
    np.testing.assert_allclose(pe, je, rtol=2.4e-7, atol=1e-6)
    assert np.isfinite(pl).all()


def test_sample_action_matches_jax_on_its_draws():
    mean, log_std, _ = _policy_inputs(1)
    key = jax.random.PRNGKey(3)
    ja, jr = (np.asarray(a) for a in jax_sample(key, jnp.asarray(mean), jnp.asarray(log_std)))
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    pa, pr = (a.numpy() for a in sample_action(*map(torch.from_numpy, (mean, log_std, noise))))
    # XLA may fuse mean + std * noise into one rounding: one ulp
    np.testing.assert_allclose(pr, jr, rtol=2.4e-7, atol=1e-7)
    np.testing.assert_allclose(pa, ja, rtol=2.4e-7, atol=1e-7)


def _obs(kind, n_agents, seed=0, b=64):
    rng = np.random.RandomState(seed)
    shape = (b, n_agents, 127) if kind == "central" else (b, 127)
    obs = rng.uniform(-1, 1, shape).astype(np.float32)
    if kind == "attention":
        # absent neighbour slots are all zero: masked keys
        for slot in range(5):
            obs[slot::5, 6 + slot * 5: 11 + slot * 5] = 0.0
        obs[::3, 6:31] = 0.0
    return obs


def _pair(kind, dtype, n_agents=4):
    fm = jax_make_model(kind).clone(compute_dtype=getattr(jnp, dtype))
    init_obs = jnp.zeros((1, n_agents, 127) if kind == "central" else (1, 127))
    params = fm.init(jax.random.PRNGKey(7), init_obs)
    pm = params_from_flax(kind, jax.tree.map(np.asarray, params),
                          make_model(kind, compute_dtype=getattr(torch, dtype)))
    return fm, params, pm


CASES = [("conv", 1), ("attention", 1), ("central", 1), ("central", 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n_agents", CASES)
def test_family_forward_matches_flax(kind, n_agents, dtype):
    fm, params, pm = _pair(kind, dtype, n_agents)
    obs = _obs(kind, n_agents)
    jm, jl, jv = (np.asarray(a) for a in jax.jit(fm.apply)(params, obs))
    with torch.no_grad():
        tm, tl, tv = (a.numpy() for a in pm(torch.from_numpy(obs)))
    assert tm.shape == jm.shape and tv.shape == jv.shape
    assert tm.dtype == tv.dtype == np.float32
    tol = (F32_ATOL, F32_ATOL) if dtype == "float32" else (BF16_ATOL["mean"], BF16_ATOL["value"])
    np.testing.assert_allclose(tm, jm, atol=tol[0], rtol=0)
    np.testing.assert_allclose(tv, jv, atol=tol[1], rtol=0)
    np.testing.assert_allclose(tl, jl, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["mlp", "conv", "attention", "central"])
def test_family_parameter_count_matches_flax(kind):
    fm = jax_make_model(kind)
    init_obs = jnp.zeros((1, 4, 127) if kind == "central" else (1, 127))
    params = jax.eval_shape(fm.init, jax.random.PRNGKey(0), init_obs)
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in make_model(kind).parameters()) == n_flax


def test_attention_ignores_absent_neighbours():
    """The tokens of absent (all-zero, masked) neighbour slots are never
    attended to: changing them leaves the ego token's readout unchanged."""
    pm = make_model("attention", compute_dtype=torch.float32)
    obs = torch.from_numpy(_obs("attention", 1, seed=2, b=8))
    obs[:, 21:31] = 0.0                                   # slots 3 and 4 absent
    with torch.no_grad():
        base = pm(obs)
        pm.pos.data[:, 4:6] += 1.0                       # their tokens change
        moved = pm(obs)
    torch.testing.assert_close(moved[0], base[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(moved[2], base[2], rtol=0, atol=1e-6)


def test_central_pools_over_the_agent_axis():
    pm = make_model("central", compute_dtype=torch.float32)
    obs = torch.from_numpy(_obs("central", 4, seed=3, b=5))
    perm = torch.tensor([2, 0, 3, 1])
    with torch.no_grad():
        m, _, v = pm(obs)
        mp, _, vp = pm(obs[:, perm])
    torch.testing.assert_close(mp, m[:, perm], rtol=0, atol=1e-6)
    torch.testing.assert_close(vp, v[:, perm], rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        pm(torch.zeros(127))


@pytest.mark.parametrize("kind", ["conv", "attention", "central"])
def test_converters_reject_a_tree_that_does_not_fit(kind):
    fm, params, _ = _pair(kind, "float32")
    p = jax.tree.map(np.asarray, params)["params"]
    with pytest.raises(ValueError):
        params_from_flax(kind, {k: v for k, v in p.items() if k != "pi_mean"})
    bad = dict(p, vf={"kernel": np.zeros((3, 1), np.float32), "bias": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="vf/kernel"):
        params_from_flax(kind, bad)


def test_make_model_seeds_every_family():
    """Seeded families; 'gru' and 'sac' are families now (the recurrent
    learner and SAC are ported), an unknown name is refused."""
    a, b = make_model("conv", seed=1), make_model("conv", seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.fuse.weight, make_model("conv", seed=2).fuse.weight)
    assert not torch.equal(make_model("gru", seed=1).gru.w_hh, make_model("gru", seed=2).gru.w_hh)
    assert make_model("sac").log_std.out_features == 2
    with pytest.raises(ValueError):
        make_model("transformer")
