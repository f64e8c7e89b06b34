"""Snapshot planning: random shooting (MPC) and the cross-entropy method over
``EnvState`` snapshots.

Counterpart of marl_traffic_intersection_tpu/algos/mcts.py. The reference
exposes get_state/set_state for rollbacks (cpp/EnvState.h:5) but ships no
planner. A snapshot is a one-env ``EnvState`` (B = 1). Planning copies it to
K envs of one batched ``env.step``, rolls K candidate action sequences over
the horizon in a Python loop (JAX's ``scan``), scores them, and returns the
best first action. The snapshot itself is never written: every candidate
starts from a copy, and ``env.step`` returns new tensors. The rollouts step
without building observations, which no score of the JAX package reads:
``score_fn`` gets each step's ``StepOutput`` with its ``obs`` left zero.

Random draws come from an explicit ``torch.Generator`` on the env's device,
or are injected, which is how the tests replay the JAX package's draws
(torch cannot reproduce jax.random streams): ``noise`` (H, K, N, 2) and
``a0`` (K, N, 2) for random shooting, ``normals`` (iters, H, K, N, 2) for
CEM. With traffic, every candidate sees the same NPC spawns, one draw per
horizon step (``spawns``: H pairs ``(do_try, route_choice)`` of one env), as
the JAX package's K copies of the snapshot share one key. CEM's iterations
share that one spawn sequence for the same reason.

The float32 arithmetic is the JAX package's as XLA compiles it on the CPU,
in its order: the smoothed actions ``rho * a + (1 - rho) * u``,
``ret + disc * score`` and ``disc * gamma``, CEM's candidates
``mean + std * u`` and its EMA of the elite mean and population std with
its floor. XLA-CPU contracts ``x * y + z`` into one fused multiply-add
(ROADMAP H3): the smoothing into ``fma(rho, a, (1 - rho) * u)`` and the
return into ``fma(disc, score, ret)``, one rounding for a product and its
sum. ``_fma`` does nearly the same (the product of two float32 values is
exact in float64; the sum is rounded to float64, then to float32, which
differs from one rounding only in rare ties), so the planned actions and
returns are bit-equal to JAX's on the tested seeds. ``mpc_policy`` and
``cem_policy`` return plain closures that plan eagerly, because each
decision rebuilds its K copies of the state; the port's counterpart of
``jit`` (utils/graphs.py, CUDA graphs of static buffers) graphs the env step
and the PPO train step.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constants import DT_DEFAULT
from ..core.env import EnvState, IntersectionEnv, StepOutput
from ..core.npc import spawn_decision

_F = torch.float32


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar that meets a
    float32 array."""
    return float(np.float32(x))


def _fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 as a fused multiply-add gives it, nearly: the
    product is exact in float64, but the sum is rounded twice, to float64 and
    then to float32. That differs from a true fma's one rounding only where
    the float64 sum lands exactly halfway between two float32 values, a rare
    tie."""
    a = a.double() if torch.is_tensor(a) else a
    return (a * b.double() + c.double()).float()


def _default_score(out: StepOutput) -> torch.Tensor:
    """Per-step score: the sum of the agents' rewards, (K,)."""
    return out.reward.sum(-1)


def _copies(state: EnvState, k: int) -> EnvState:
    """``k`` copies of the one-env snapshot ``state``, each tensor its own."""
    if state.step_count.shape[0] != 1:
        raise ValueError(f"a snapshot holds one env, got {state.step_count.shape[0]}")

    def rep(t):
        return t.expand((k,) + tuple(t.shape[1:])).clone()

    return EnvState(ego=type(state.ego)(*map(rep, state.ego)), lidar=rep(state.lidar),
                    step_count=rep(state.step_count),
                    npc=type(state.npc)(*map(rep, state.npc)))


def _spawn_draws(env: IntersectionEnv, generator, horizon: int, spawns, dt):
    """The horizon's spawn draws, one env's each (None without traffic)."""
    cfg = env.config
    if not cfg.traffic_flow:
        return None
    if spawns is None:
        spawns = [spawn_decision(generator, 1, env.traffic_ids.shape[0],
                                 cfg.traffic_density, dt) for _ in range(horizon)]
    if len(spawns) != horizon:
        raise ValueError(f"spawns: {len(spawns)} draws for a horizon of {horizon}")
    return [tuple(torch.as_tensor(t, device=env.device).reshape(1) for t in d)
            for d in spawns]


def _returns(env: IntersectionEnv, batched: EnvState, actions: torch.Tensor, gamma: float,
             score_fn: Callable, spawns, dt) -> torch.Tensor:
    """Discounted returns (K,) of the action sequences ``actions`` (H, K, N, 2)
    rolled from ``batched``."""
    K = actions.shape[1]
    dev = env.device
    disc = torch.ones((), dtype=_F, device=dev)
    g = torch.full((), _f32(gamma), dtype=_F, device=dev)
    ret = torch.zeros((K,), dtype=_F, device=dev)
    st = batched
    for t in range(actions.shape[0]):
        spawn = None if spawns is None else tuple(s.expand(K) for s in spawns[t])
        st, out = env.step(st, actions[t], dt, with_obs=False, spawn=spawn)
        ret = _fma(disc, score_fn(out), ret)
        disc = disc * g
    return ret


def _need(generator, what: str):
    if generator is None:
        raise ValueError(f"planning needs a torch.Generator or injected {what}")
    return generator


def random_shooting_plan(env: IntersectionEnv, state: EnvState,
                         generator: Optional[torch.Generator] = None,
                         num_candidates: int = 256, horizon: int = 20, gamma: float = 0.99,
                         action_smooth: float = 0.7, score_fn: Callable = _default_score,
                         noise: Optional[torch.Tensor] = None,
                         a0: Optional[torch.Tensor] = None,
                         spawns: Optional[Sequence] = None, dt: float = DT_DEFAULT
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan one action for the snapshot ``state`` by rolling K candidate
    action sequences (smoothed uniform noise) over the horizon.

    Returns (best_action (N, 2), best_return ()). ``noise`` (H, K, N, 2) and
    ``a0`` (K, N, 2), uniform in [-1, 1), replace the generator's draws.
    """
    n, dev = env.config.num_agents, env.device
    shape = (num_candidates, n, 2)
    if noise is None:
        noise = torch.rand((horizon,) + shape, generator=_need(generator, "noise"),
                           device=dev) * 2.0 - 1.0
    if a0 is None:
        a0 = torch.rand(shape, generator=_need(generator, "a0"), device=dev) * 2.0 - 1.0
    noise, a = noise.to(dev, _F), a0.to(dev, _F)
    rho, one_minus = _f32(action_smooth), _f32(1.0 - action_smooth)
    steps = []
    for u in noise:                                   # a_t = rho a_{t-1} + (1 - rho) u_t
        a = _fma(rho, a, one_minus * u)
        steps.append(a)
    actions = torch.stack(steps)                      # (H, K, N, 2)
    draws = _spawn_draws(env, generator, horizon, spawns, dt)
    returns = _returns(env, _copies(state, num_candidates), actions, gamma, score_fn, draws,
                       dt)
    best = torch.argmax(returns)
    return actions[0, best], returns[best]


def mpc_policy(env: IntersectionEnv, num_candidates: int = 256, horizon: int = 20,
               seed: int = 0, **kw):
    """A closure ``(state, generator=None, **draws) -> (action (N, 2), return ())``
    planning with random shooting; its own generator (``seed``) draws when the
    call passes none."""
    own = torch.Generator(device=env.device).manual_seed(seed)

    def plan(state: EnvState, generator: Optional[torch.Generator] = None, **draws):
        return random_shooting_plan(env, state, generator or own,
                                    num_candidates=num_candidates, horizon=horizon,
                                    **kw, **draws)

    return plan


def cem_plan(env: IntersectionEnv, state: EnvState,
             generator: Optional[torch.Generator] = None, num_candidates: int = 64,
             num_iters: int = 4, num_elites: int = 8, horizon: int = 20, gamma: float = 0.99,
             init_std: float = 0.6, std_floor: float = 0.05, alpha: float = 0.3,
             score_fn: Callable = _default_score, init_mean: Optional[torch.Tensor] = None,
             normals: Optional[torch.Tensor] = None, spawns: Optional[Sequence] = None,
             dt: float = DT_DEFAULT) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-entropy-method planning over the snapshot ``state``.

    Refits a diagonal Gaussian over action sequences (H, N, 2) ``num_iters``
    times: K candidates rolled from the snapshot, the top ``num_elites`` by
    discounted return, their mean and population std blended into the old
    ones (``alpha`` keeps of the old), the std floored at ``std_floor``. At
    an equal budget with random shooting, K_shooting = K * num_iters.
    Returns (first_action (N, 2), best_return of the last iteration (),
    mean (H, N, 2)); pass the mean, shifted one step, back as ``init_mean``
    for a receding-horizon warm start. ``normals`` (iters, H, K, N, 2)
    replace the generator's standard normal draws.
    """
    n, dev = env.config.num_agents, env.device
    if normals is None:
        normals = torch.randn((num_iters, horizon, num_candidates, n, 2),
                              generator=_need(generator, "normals"), device=dev)
    normals = normals.to(dev, _F)
    draws = _spawn_draws(env, generator, horizon, spawns, dt)
    batched = _copies(state, num_candidates)
    mean = (torch.zeros((horizon, n, 2), dtype=_F, device=dev) if init_mean is None
            else torch.as_tensor(init_mean, dtype=_F).to(dev))
    std = torch.full((horizon, n, 2), _f32(init_std), dtype=_F, device=dev)
    keep, blend = _f32(alpha), _f32(1.0 - alpha)
    floor = torch.full((), _f32(std_floor), dtype=_F, device=dev)
    best = None
    for u in normals:
        acts = torch.clamp(_fma(std[:, None], u, mean[:, None]), -1.0, 1.0)   # (H, K, N, 2)
        rets = _returns(env, batched, acts, gamma, score_fn, draws, dt)
        elites = acts[:, torch.topk(rets, num_elites).indices]          # (H, E, N, 2)
        e_mean = elites.mean(1)
        e_std = elites.std(1, correction=0)
        mean = _fma(blend, e_mean, keep * mean)
        std = torch.maximum(_fma(blend, e_std, keep * std), floor)
        best = rets.max()
    return torch.clamp(mean[0], -1.0, 1.0), best, mean


def cem_policy(env: IntersectionEnv, seed: int = 0, **kw):
    """A receding-horizon closure ``(state, warm_mean, generator=None, **draws)
    -> (action, best_return, next_warm_mean)``: CEM from ``warm_mean``, whose
    plan is then shifted one step (the last step repeated) for the next call.
    Its own generator (``seed``) draws when the call passes none."""
    own = torch.Generator(device=env.device).manual_seed(seed)

    def plan(state: EnvState, warm_mean: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, **draws):
        act, best, mean = cem_plan(env, state, generator or own, init_mean=warm_mean,
                                   **kw, **draws)
        return act, best, torch.cat([mean[1:], mean[-1:]], 0)

    return plan
