"""The port's NPC functions (core/npc.py, CPU) against the JAX package's.

Fixtures are seeded numpy NPC pools of M = 32 slots in several envs, the
cars placed on their routes' middle sections (where the ghost scans and the
front-car checks interact), some placed onto each other so that the
collision passes have overlaps to remove. The JAX functions run vmapped over
the envs on the reference chain (tests/_torch_port.py); every field of every
result is compared by bit pattern.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.core import npc as jnpc
from marl_traffic_intersection_tpu.core.physics import update_path_index as jax_path_index
from marl_traffic_intersection_tpu.core.routes import build_route_table
from marl_traffic_intersection_tpu_torch.core import npc
from marl_traffic_intersection_tpu_torch.core.constants import PATH_LEN
from marl_traffic_intersection_tpu_torch.core.physics import update_path_index

from ._torch_port import assert_bits, assert_npc_bits, ieee_constant_division, port_env

B, M = 6, 32
DT = np.float32(1.0 / 60.0)
TABLE = build_route_table(3)
PATHS = TABLE.paths


def _fixture(seed, p_alive=0.6, overlaps=0):
    """An NpcState as numpy arrays (B, M) (next_uid (B,))."""
    rng = np.random.RandomState(seed)
    T = TABLE.traffic_route_ids
    route = T[rng.randint(len(T), size=(B, M))].astype(np.int32)
    pi = rng.randint(35, 125, size=(B, M)).astype(np.int32)
    here, ahead = PATHS[route, pi], PATHS[route, pi + 1]
    heading = np.arctan2(-(ahead[..., 1] - here[..., 1]), ahead[..., 0] - here[..., 0])
    f = np.float32
    st = dict(
        alive=rng.uniform(size=(B, M)) < p_alive,
        x=(here[..., 0] + rng.normal(0, 3, (B, M))).astype(f),
        y=(here[..., 1] + rng.normal(0, 3, (B, M))).astype(f),
        v=rng.uniform(0, 8, (B, M)).astype(f),
        heading=(heading + rng.normal(0, 0.1, (B, M))).astype(f),
        steering_angle=rng.uniform(-0.3, 0.3, (B, M)).astype(f),
        route_id=route, path_index=(pi - rng.randint(0, 3, (B, M))).astype(np.int32),
        uid=np.stack([rng.permutation(M) + 5 for _ in range(B)]).astype(np.int32),
        next_uid=np.full((B,), M + 5, np.int32))
    for b in range(B):           # a few cars pushed onto others (chains too)
        for j in rng.choice(M - 1, overlaps, replace=False):
            st["x"][b, j + 1] = st["x"][b, j] + f(rng.uniform(-20, 20))
            st["y"][b, j + 1] = st["y"][b, j] + f(rng.uniform(-8, 8))
            st["alive"][b, j:j + 2] = True
    return st


def _port(st):
    return npc.NpcState(**{k: torch.from_numpy(np.array(v)) for k, v in st.items()})


def _jax(st):
    return jnpc.NpcState(**{k: jnp.asarray(v) for k, v in st.items()})


def _run_jax(fn, *args):
    """``fn`` vmapped over the env axis of every argument, compiled on the
    reference chain."""
    with ieee_constant_division():
        lowered = jax.jit(jax.vmap(fn)).lower(*args)
    return lowered.compile()(*args)


def _port_args():
    t = {k: torch.from_numpy(np.asarray(getattr(TABLE, k))) for k in
         ("paths", "goal_xy", "spawn_xy", "spawn_heading", "traffic_route_ids")}
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_try_spawn_matches_including_a_full_pool(seed):
    """One env's pool is full (tests/test_npc.py:119: the spawn is dropped),
    one env's spawn point is blocked by an ego, one by an NPC."""
    st = _fixture(seed, p_alive=0.5)
    st["alive"][0] = True
    rng = np.random.RandomState(seed + 7)
    T = len(TABLE.traffic_route_ids)
    rc = rng.randint(T, size=B).astype(np.int32)
    do_try = np.ones(B, bool)
    do_try[1] = False
    ego_x = rng.uniform(0, 750, (B, 2)).astype(np.float32)
    ego_y = rng.uniform(0, 750, (B, 2)).astype(np.float32)
    sp = TABLE.spawn_xy[TABLE.traffic_route_ids[rc]]
    ego_x[2, 0], ego_y[2, 0] = sp[2] + 30.0                        # blocks env 2
    st["x"][3, 5], st["y"][3, 5], st["alive"][3, 5] = sp[3, 0] - 40.0, sp[3, 1], True
    present = np.ones((B, 2), bool)
    t = _port_args()
    got, spawned = npc.npc_try_spawn(_port(st), torch.from_numpy(do_try), torch.from_numpy(rc),
                                     torch.from_numpy(ego_x), torch.from_numpy(ego_y),
                                     torch.from_numpy(present), t["traffic_route_ids"],
                                     t["spawn_xy"], t["spawn_heading"])
    ids, sxy, sh = (jnp.asarray(getattr(TABLE, k)) for k in
                    ("traffic_route_ids", "spawn_xy", "spawn_heading"))
    want, jspawned = _run_jax(lambda s, d, r, ex, ey, ep: jnpc.npc_try_spawn(
        s, d, r, ex, ey, ep, ids, sxy, sh), _jax(st), jnp.asarray(do_try), jnp.asarray(rc),
        jnp.asarray(ego_x), jnp.asarray(ego_y), jnp.asarray(present))
    assert_npc_bits(want, got)
    assert_bits("spawned", np.asarray(jspawned), spawned.numpy())
    assert not spawned[:4].any() and spawned[4:].all()


def test_despawn_matches():
    st = _fixture(2, p_alive=0.9)
    goal = TABLE.goal_xy[st["route_id"]]
    st["x"][:, :4] = goal[:, :4, 0] + np.float32(12.0)     # within 20 px of the goal
    st["y"][:, :4] = goal[:, :4, 1]
    st["y"][:, 4:6] = np.float32(-150.0)                    # off the screen
    got = npc.npc_despawn(_port(st), _port_args()["goal_xy"])
    gxy = jnp.asarray(TABLE.goal_xy)
    want = _run_jax(lambda s: jnpc.npc_despawn(s, gxy), _jax(st))
    assert_npc_bits(want, got)
    assert not got.alive[:, :6].any()


@pytest.mark.parametrize("name", ["npc_collisions", "npc_collisions_serial",
                                  "npc_collisions_fast"])
def test_collisions_match_on_overlapping_poses(name):
    st = _fixture(3, p_alive=0.7, overlaps=6)
    got = getattr(npc, name)(_port(st))
    want = _run_jax(getattr(jnpc, name), _jax(st))
    assert_npc_bits(want, got)
    removed = int((st["alive"] & ~got.alive.numpy()).sum())
    assert removed >= B, removed


def test_plan_throttle_and_steer_bit_for_bit():
    """Every slot plans against its pool (the dense pass of the exact mode)."""
    st = _fixture(4, p_alive=0.8)
    p, t = _port(st), _port_args()
    paths = t["paths"][p.route_id.long()]
    pi0 = update_path_index(paths, PATH_LEN, p.path_index, p.x, p.y)
    others = p.alive[:, None, :] & ~torch.eye(M, dtype=torch.bool)
    th, steer = npc._plan(p.x, p.y, p.v, p.heading, p.uid, others, pi0, paths,
                          (p.x, p.y, p.v, p.heading, p.uid))
    jpaths = jnp.asarray(PATHS)

    def plan_env(s):
        ps = jpaths[s.route_id]
        pi = jax_path_index(ps, PATH_LEN, s.path_index, s.x, s.y)
        eye = jnp.eye(M, dtype=bool)
        return jax.vmap(lambda sx, sy, sv, sh, su, pp, path, oh: jnpc._plan_npc_action(
            sx, sy, sv, sh, su, s.alive & ~oh, pp, s.x, s.y, s.v, s.heading, s.uid, path))(
            s.x, s.y, s.v, s.heading, s.uid, pi, ps, eye)

    jth, jsteer = _run_jax(plan_env, _jax(st))
    assert_bits("throttle", np.asarray(jth), th.numpy())
    assert_bits("steer", np.asarray(jsteer), steer.numpy())
    # the ghost scan, the front-car check and the cruise all decided some plans
    assert {-1.0, 0.5} <= set(np.unique(th.numpy()).tolist())


@pytest.mark.parametrize("mode", ["slot", "wave", "serial", "fast"])
def test_controller_updates_match(mode):
    st = _fixture(5, p_alive=0.7)
    paths = _port_args()["paths"]
    dt = torch.tensor(DT)
    jpaths, jdt = jnp.asarray(PATHS), jnp.float32(DT)
    if mode in ("slot", "wave"):
        got = npc.npc_controller_update(_port(st), paths, dt, wave_cleanup=mode == "wave")
        fn = lambda s: jnpc.npc_controller_update(s, jpaths, jdt, wave_cleanup=mode == "wave",
                                                  exact_acc=True)
    elif mode == "serial":
        got = npc.npc_controller_update_serial(_port(st), paths, dt)
        fn = lambda s: jnpc.npc_controller_update_serial(s, jpaths, jdt, exact_acc=True)
    else:
        got = npc.npc_controller_update_fast(_port(st), paths, dt)
        fn = lambda s: jnpc.npc_controller_update_fast(s, jpaths, jdt, exact_acc=True)
    assert_npc_bits(_run_jax(fn, _jax(st)), got)
    moved = (got.x.numpy() != st["x"]) & st["alive"]
    assert moved.sum() >= st["alive"].sum() // 2


def test_exact_slot_and_wave_equal_serial_at_density_10():
    """tests/test_npc.py:160-190 for the port: density 10 with a forced spawn
    try every 31 steps, 3 envs; every NpcState field, every step, bit for bit."""
    runs = {}
    for mode, cleanup in (("exact", "slot"), ("exact", "wave"), ("serial", "slot")):
        env = port_env(1, traffic_flow=True, traffic_density=10.0, npc_mode=mode,
                       npc_cleanup=cleanup, max_steps=4000)
        state, _ = env.reset(num_envs=3)
        T = env.traffic_ids.shape[0]
        rng = np.random.RandomState(20)
        traj = []
        for t in range(200):
            do_try = (rng.uniform(size=3) < 1.0 - np.exp(-10.0 / 60.0)) | (t % 31 == 5)
            rc = rng.randint(T, size=3).astype(np.int32)
            state, _ = env.step(state, torch.tensor([[[0.3, 0.0]]]).expand(3, 1, 2),
                                spawn=(torch.from_numpy(do_try), torch.from_numpy(rc)))
            traj.append(state.npc)
        runs[(mode, cleanup)] = traj
        if mode == "exact":
            assert env.npc_stats["cleanup_rounds"] > 0 and env.npc_stats["host_reads"] > 0
    ref = runs[("serial", "slot")]
    assert int(ref[-1].alive.sum()) >= 6
    for key in (("exact", "slot"), ("exact", "wave")):
        for t, (a, b) in enumerate(zip(runs[key], ref)):
            assert_npc_bits(b, a, f"{key} step {t}")


def test_env_state_with_npcs_converts_from_and_to_numpy():
    """A traffic state to numpy and back is the same state, NPC pool included,
    and steps the same; a single JAX env's leaves gain the env axis."""
    from marl_traffic_intersection_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
    env = port_env(2, traffic_flow=True, traffic_density=5.0)
    state, _ = env.reset(num_envs=3)
    # the traffic route whose spawn point lies farthest from the egos
    sp = env.spawn_xy[env.traffic_ids.long()]
    gap = torch.cdist(sp, torch.stack([state.ego.x[0], state.ego.y[0]], -1)).amin(1)
    spawn = (torch.ones(3, dtype=torch.bool), gap.argmax().to(torch.int32).expand(3))
    drive = torch.tensor([0.6, 0.0]).expand(3, 2, 2)
    for _ in range(40):
        state, _ = env.step(state, drive, spawn=spawn)
    assert int(state.npc.alive.sum()) > 0
    leaves = env_state_to_numpy(state)
    back = env_state_from_numpy(leaves["ego"], leaves["lidar"], leaves["step_count"],
                                npc=leaves["npc"])
    assert_npc_bits(state.npc, back.npc)
    (s1, o1), (s2, o2) = (env.step(s, drive, spawn=spawn) for s in (state, back))
    assert_bits("obs", o1.obs, o2.obs)
    assert_npc_bits(s1.npc, s2.npc)

    js = _jax_reset_traffic_state()
    one = env_state_from_numpy({f: np.asarray(getattr(js.ego, f)) for f in js.ego._fields},
                               js.lidar, js.step_count, batched=False,
                               npc={f: np.asarray(getattr(js.npc, f)) for f in js.npc._fields})
    assert one.npc.alive.shape == (1, 32) and one.npc.next_uid.shape == (1,)


def _jax_reset_traffic_state():
    from marl_traffic_intersection_tpu import EnvConfig, IntersectionEnv
    env = IntersectionEnv(EnvConfig(num_agents=2, traffic_flow=True))
    return env.reset_state(jax.random.PRNGKey(0))
