"""The port's mesh (parallel/mesh.py) against the JAX package's: the
tensor-parallel rules split the same parameters on the transposed dims, the
sharded forward of every family agrees with JAX's mesh-sharded forward on the
same weights, and the meshes' shapes and data shards.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py. The
port's sharded forward needs a model group: one gloo group of tp processes
per tp (2 and 4), spawned once for all families (``tests/_torch_dist.py::
tp_forwards``); the 4-process group also builds the hybrid meshes.
"""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.models import MODEL_FAMILIES as JAX_FAMILIES
from marl_traffic_intersection_tpu.models.sac import QCritic, SquashedGaussianActor
from marl_traffic_intersection_tpu.parallel import mesh as jmesh
from marl_traffic_intersection_tpu_torch import convert
from marl_traffic_intersection_tpu_torch.dryrun import spawn
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.models.sac import TwinQCritic
from marl_traffic_intersection_tpu_torch.parallel.mesh import param_shardings

from . import _torch_dist
from . import _torch_port  # noqa: F401  (one torch thread per test worker)

FAMILIES = ("mlp", "attention", "conv", "gru", "central", "sac", "sac_q")
F32 = dict(compute_dtype=torch.float32)
# float32 forward, JAX's mesh-sharded program against the port's row-parallel
# all-reduce: the partial sums add in other orders
FORWARD_TOL = 5e-6


def _tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(params))


@functools.lru_cache(maxsize=None)
def _jax_family(kind):
    """(flax module, params, inputs as numpy) of a float32 family."""
    rng = np.random.RandomState(FAMILIES.index(kind))
    obs = rng.normal(size=(6, 127)).astype(np.float32)
    obs[::2, 6:31] = 0.0                  # absent neighbours: attention's key mask
    key = jax.random.PRNGKey(FAMILIES.index(kind))
    if kind == "sac_q":
        module = QCritic(compute_dtype=jnp.float32)
        act = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
        params = jax.vmap(lambda k: module.init(k, obs[:1], act[:1]))(
            jax.random.split(key, 2))
        return module, params, (obs, act)
    if kind == "sac":
        module = SquashedGaussianActor(compute_dtype=jnp.float32)
        return module, module.init(key, obs[:1]), (obs,)
    module = JAX_FAMILIES[kind](compute_dtype=jnp.float32)
    if kind == "gru":
        h = rng.normal(size=(6, 128)).astype(np.float32)
        return module, module.init(key, obs[:1], h[:1]), (obs, h)
    if kind == "central":
        obs = obs.reshape(3, 2, 127)
    return module, module.init(key, obs[None, :1] if kind == "central" else obs[:1]), (obs,)


def _port(kind):
    """The port's float32 module of ``kind`` with the JAX weights."""
    _, params, _ = _jax_family(kind)
    if kind == "sac_q":
        return convert.sac_critic_params_from_flax(_tree(params), TwinQCritic(**F32))
    return convert.params_from_flax(kind, _tree(params), make_model(kind, **F32))


def _entries(kind, model):
    """(flax path, port parameter, converter) of every leaf."""
    if kind == "sac_q":
        names = [f"torso_{i}" for i in range(len(model.kernels) - 1)] + ["q"]
        return [e for n, w, b in zip(names, model.kernels, model.biases)
                for e in ((f"{n}/kernel", w, convert._same), (f"{n}/bias", b, convert._same))]
    return convert.ENTRIES[kind](model)


def _jax_specs(kind, tp):
    module, params, _ = _jax_family(kind)
    mesh = jmesh.make_mesh(n_data=8 // tp, n_model=tp)
    sh = jmesh.param_shardings(mesh, params, kind)
    specs = {}
    for path, s in jax.tree_util.tree_leaves_with_path(sh):
        specs["/".join(str(getattr(p, "key", p)) for p in path[1:])] = tuple(s.spec)
    return mesh, params, sh, specs


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", FAMILIES)
def test_rules_split_the_parameters_jax_splits(kind, tp):
    """Each flax leaf the JAX rule splits over 'model' is split by the port's
    rule on the dim its converter maps it to, into the same blocks; every
    other leaf is whole on both sides."""
    model = _port(kind)
    dims = param_shardings(model, kind, tp)
    names = {id(p): n for n, p in model.named_parameters()}
    _, _, _, specs = _jax_specs(kind, tp)
    params = _tree(_jax_family(kind)[1])["params"]
    split = 0
    for path, param, conv in _entries(kind, model):
        spec = specs[path]
        # the GRU cell's entries are row blocks (views) of its fused matrices
        name = names.get(id(param), names.get(id(getattr(param, "_base", None))))
        d_f = spec.index("model") if "model" in spec else None
        d_p = dims[name]
        if d_f is None:
            assert d_p is None, (path, name, d_p)
            continue
        assert d_p is not None, (path, name)
        leaf = params
        for k in path.split("/"):
            leaf = leaf[k]
        block = np.indices(leaf.shape)[d_f] // (leaf.shape[d_f] // tp)
        ported = np.asarray(conv(block))
        k = ported.shape[d_p] // tp
        for j in range(tp):
            assert (np.take(ported, range(j * k, (j + 1) * k), axis=d_p) == j).all(), (path, j)
        split += 1
    assert split > 0


@functools.lru_cache(maxsize=None)
def _port_forwards(tp):
    """Every family's forward split over tp gloo processes."""
    weights = {k: (_port(k).state_dict(), tuple(torch.from_numpy(x) for x in _jax_family(k)[2]))
               for k in FAMILIES}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(weights, os.path.join(tmp, "w.pt"))
        spawn(_torch_dist.tp_forwards, tp, (os.path.join(tmp, "out.pt"),
                                            os.path.join(tmp, "w.pt")), timeout=240)
        return torch.load(os.path.join(tmp, "out.pt"))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", FAMILIES)
def test_sharded_forward_agrees_with_jax_mesh_forward(kind, tp):
    module, params, inputs = _jax_family(kind)
    mesh, _, sh, _ = _jax_specs(kind, tp)
    sharded = jax.tree.map(jax.device_put, params, sh)
    if kind == "sac_q":
        fn = jax.jit(jax.vmap(module.apply, in_axes=(0, None, None)))
    else:
        fn = jax.jit(module.apply)
    want = fn(sharded, *inputs)
    want = want if isinstance(want, tuple) else (want,)
    got = _port_forwards(tp)[kind]
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        print(f"{kind} tp {tp}: within {err:.3g} of JAX")
        assert err <= FORWARD_TOL, (kind, tp, err)


def test_hybrid_mesh_shape_and_data_shards():
    """On one node the hybrid mesh is (1, W // tp, tp); with torchrun's
    LOCAL_WORLD_SIZE of two nodes it is (2, 1, 2) and the env batch splits
    over replica x data; shard then gather returns the batch."""
    r = _port_forwards(4)
    assert r["one node"]["shape"] == (1, 2, 2)
    assert r["one node"]["dims"] == ("replica", "data", "model")
    assert r["two nodes"]["shape"] == (2, 1, 2)
    assert r["2d"]["shape"] == (2, 2) and r["2d"]["dims"] == ("data", "model")
    # rank = data index * tp + model index; the two nodes' data index is the replica's
    assert r["2d"]["data"] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert r["two nodes"]["data"] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert all(r[m]["round_trip"] for m in ("2d", "one node", "two nodes"))
