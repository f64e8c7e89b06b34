"""The shipped policies as the port reads them: the committed numpy exports
against the JAX package's orbax stores, and every family loaded from them
against the JAX package's ``load_policy`` forward.

Tolerances. A trained policy's outputs are larger than a fresh one's (means
up to 18, values up to 36 on these observations, against below 0.03 and 2.3
in tests/test_torch_models.py), so the bounds of that file (1e-5 in float32;
a bf16 ulp, 2^-8 relative, per layer in bfloat16) are taken relative to the
largest magnitude of each output: float32 within ``F32_REL`` of it (the
products sum in another order; measured at most 1.5e-6 of it), bfloat16
within ``BF16_REL`` = 2^-5 of it, eight bf16 ulps at the top of the range
(measured at most 0.018, the attention family's value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.utils.checkpoint import load_policy as jax_load_policy
from marl_traffic_intersection_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from marl_traffic_intersection_tpu_torch.convert import params_from_flax
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.utils.checkpoint import (EXPORTS, load_policy, load_sac,
                                                                  read_export)

from ._torch_port import ARTIFACTS, adam_leaves, export_leaves, shipped_policies

F32_REL = 1e-5
BF16_REL = 2.0 ** -5
FAMILIES = {"mlp": "policy_mlp_multi", "conv": "policy_conv_multi",
            "attention": "policy_attn_multi", "central": "policy_central_cfg4",
            "gru": "policy_gru_multi", "sac": "policy_sac_multi"}


ADAM = ".adam.npz"
PPO_STORES = [n for n in shipped_policies() if not n.startswith("policy_sac")]


def test_every_shipped_artifact_has_an_export():
    """One weights export per store, and one Adam export per PPO-family
    store (the SAC stores hold no optimizer state)."""
    assert len(shipped_policies()) == 12 and len(PPO_STORES) == 10
    files = sorted(p.name for p in EXPORTS.glob("*.npz"))
    assert [f for f in files if not f.endswith(ADAM)] == [f"{n}.npz" for n in shipped_policies()]
    assert [f for f in files if f.endswith(ADAM)] == [f"{n}{ADAM}" for n in PPO_STORES]


@pytest.mark.parametrize("name", shipped_policies())
def test_export_is_bit_equal_to_the_orbax_store(name):
    want = export_leaves(jax_restore(str(ARTIFACTS / name)))
    with np.load(EXPORTS / f"{name}.npz") as z:
        assert sorted(z.files) == sorted(want)
        for key, leaf in want.items():
            got = z[key]
            assert got.dtype == np.float32 and got.shape == leaf.shape, key
            np.testing.assert_array_equal(got.view(np.int32), leaf.view(np.int32), err_msg=key)


@pytest.mark.parametrize("name", PPO_STORES)
def test_adam_export_is_bit_equal_to_the_orbax_store(name):
    """Adam's count, mu and nu at opt_state[1][0] and the store's update."""
    store = jax_restore(str(ARTIFACTS / name))
    want = adam_leaves(store)
    with np.load(EXPORTS / f"{name}{ADAM}") as z:
        assert sorted(z.files) == sorted(want)
        for key, leaf in want.items():
            got = z[key]
            assert got.dtype == leaf.dtype and got.shape == leaf.shape, key
            np.testing.assert_array_equal(got, leaf, err_msg=key)
            if got.dtype == np.float32:
                np.testing.assert_array_equal(got.view(np.int32), leaf.view(np.int32),
                                              err_msg=key)
        assert int(z["update"]) == int(store["update"]) > 0
        assert int(z["count"]) == int(store["opt_state"][1][0]["count"]) > 0
        # one moment per parameter, laid out as the parameter
        params = export_leaves(store)
        for group in ("mu", "nu"):
            mom = {k.split("/", 1)[1]: v for k, v in want.items() if k.startswith(group + "/")}
            assert {k: v.shape for k, v in mom.items()} == \
                   {k.split("/", 1)[1]: v.shape for k, v in params.items()}


def _obs(kind, seed=0, n=256):
    obs = np.random.RandomState(seed).uniform(-1, 1, (n, 127)).astype(np.float32)
    return obs.reshape(n // 4, 4, 127) if kind == "central" else obs


def test_gru_export_over_a_sequence_matches_the_jax_forward():
    """policy_gru_multi over 16 steps of seeded observations in bfloat16: the
    means within ``BF16_REL`` of the largest at every step (measured at most
    0.0064 on 4096 observations of this seed). The hidden state drifts
    further (measured 0.047 by step 15 there, several bf16 ulps): the trained
    recurrence carries each step's rounding differences on, so it is bounded
    in float32, by the next test."""
    jmodel, params, _ = jax_load_policy(str(ARTIFACTS / "policy_gru_multi"), "gru")
    model, mean_fn = load_policy("policy_gru_multi", "gru")
    seq = np.random.RandomState(11).uniform(-1, 1, (16, 256, 127)).astype(np.float32)
    apply = jax.jit(jmodel.apply)
    jh, th = np.zeros((256, 128), np.float32), model.initial_hidden(256)
    for t in range(16):
        jm, _, _, jh = apply(params, seq[t], jh)
        tm, th = mean_fn(torch.from_numpy(seq[t]), th)
        w = np.asarray(jm)
        np.testing.assert_allclose(tm.numpy(), w, rtol=0,
                                   atol=BF16_REL * max(1.0, np.abs(w).max()), err_msg=f"step {t}")


def test_gru_export_over_a_sequence_in_float32_bounds_the_hidden_state():
    """policy_gru_multi over 16 steps in float32: the means within ``F32_REL``
    of the largest and the hidden state (|h| < 1) within ``F32_REL`` at every
    step, where no rounding to bf16 can carry a difference on."""
    jmodel, params, _ = jax_load_policy(str(ARTIFACTS / "policy_gru_multi"), "gru")
    jmodel = jmodel.clone(compute_dtype=jnp.float32)
    tree = read_export(EXPORTS / "policy_gru_multi.npz")["params"]
    model = params_from_flax("gru", tree, make_model("gru", compute_dtype=torch.float32)).eval()
    seq = np.random.RandomState(11).uniform(-1, 1, (16, 256, 127)).astype(np.float32)
    apply = jax.jit(jmodel.apply)
    jh, th = np.zeros((256, 128), np.float32), model.initial_hidden(256)
    for t in range(16):
        jm, _, _, jh = apply(params, seq[t], jh)
        with torch.no_grad():
            tm, _, _, th = model(torch.from_numpy(seq[t]), th)
        w = np.asarray(jm)
        np.testing.assert_allclose(tm.numpy(), w, rtol=0,
                                   atol=F32_REL * max(1.0, np.abs(w).max()), err_msg=f"step {t}")
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=F32_REL,
                                   err_msg=f"step {t}")


def _outputs(kind, fwd, obs, h):
    """The outputs compared: means and values (log_std heads for SAC), and the
    new hidden state for the GRU."""
    if kind == "gru":
        mean, _, value, h_new = fwd(obs, h)
        return mean, value, h_new
    out = fwd(obs)
    return (out[0], out[1]) if kind == "sac" else (out[0], out[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_family_from_its_export_matches_the_jax_forward(kind, dtype):
    name = FAMILIES[kind]
    jmodel, params, _ = jax_load_policy(str(ARTIFACTS / name), kind)
    jmodel = jmodel.clone(compute_dtype=getattr(jnp, dtype))
    tree = read_export(EXPORTS / f"{name}.npz")["actor_params" if kind == "sac" else "params"]
    model = params_from_flax(kind, tree, make_model(kind, compute_dtype=getattr(torch, dtype)))
    obs = _obs(kind)
    h = np.random.RandomState(1).uniform(-1, 1, (256, 128)).astype(np.float32)
    want = _outputs(kind, jax.jit(lambda *a: jmodel.apply(params, *a)), obs, h)
    with torch.no_grad():
        got = _outputs(kind, model, torch.from_numpy(obs), torch.from_numpy(h))
    rel = F32_REL if dtype == "float32" else BF16_REL
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32, i
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1.0, np.abs(w).max()),
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("spelling", ["artifacts/policy_gru_multi", "policy_gru_multi",
                                      "policy_gru_multi.npz"])
def test_load_policy_resolves_a_shipped_name(spelling):
    model, mean_fn = load_policy(spelling, "gru")
    obs, h = torch.from_numpy(_obs("gru", n=8)), model.initial_hidden(8)
    mean, h_new = mean_fn(obs, h)
    assert mean.shape == (8, 2) and h_new.shape == (8, 128) and not model.training
    want = read_export(EXPORTS / "policy_gru_multi.npz")["params"]["gru"]["hn"]["bias"]
    np.testing.assert_array_equal(model.gru.b_hn.detach().numpy(), want)


def test_load_policy_raises_naming_both_places(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        load_policy(tmp_path / "policy_nope", "mlp")
    assert "checkpoint.pt" in str(e.value) and "policy_nope.npz" in str(e.value)
    # a run directory without a snapshot never falls back to the shipped
    # policy of the same name
    run = tmp_path / "runs" / "policy_mlp_multi"
    run.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="checkpoint.pt"):
        load_policy(run, "mlp")
    with pytest.raises(FileNotFoundError):
        load_policy(run, "sac")


def test_load_sac_reads_the_actor_and_the_stacked_critics():
    actor, critic = load_sac("artifacts/policy_sac_cfg1")
    q = read_export(EXPORTS / "policy_sac_cfg1.npz")["q_params"]
    assert tuple(critic.kernels[0].shape) == (2, 129, 256)
    np.testing.assert_array_equal(critic.kernels[0].detach().numpy(), q["torso_0"]["kernel"])
    np.testing.assert_array_equal(critic.biases[2].detach().numpy(), q["q"]["bias"])
    assert critic(torch.zeros(3, 127), torch.zeros(3, 2)).shape == (2, 3)
    assert actor(torch.zeros(3, 127))[0].shape == (3, 2)
