"""Policy evaluation flows.

Re-expresses the reference evaluator/predictor scripts (solvers/evaluator.py,
solvers/predictor.py) as batched on-device programs:

- the reference compares controllers by replaying the *same generated day*
  across models via ``initial_values.json`` round-trips
  (solvers/evaluator.py:89-101, its only fixture mechanism);
  :func:`evaluate_policies_same_days` does the same thing on device: one
  schedule batch is generated once and shared by every policy, so comparisons
  are paired sample-for-sample — no file IO needed;
- the reference predictor rolls a single day per trained model and dumps
  telemetry (solvers/predictor.py:85-94); :func:`predict_single_day` returns
  the full stacked StepInfo telemetry for one day.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout
from ..core.state import StepInfo
from ..core.transition import reset as core_reset, step as core_step


def evaluate_policies_same_days(
    config: NanogridConfig,
    params: NanogridParams,
    policies: dict[str, Callable],
    num_days: int = 100,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Evaluate several policies on identical generated days (paired design).

    ``policies`` maps name -> ``policy(obs, key) -> actions`` (vectorized over a
    leading batch axis).  Returns name -> per-day returns array of shape
    (num_days,).  Mirrors the reference evaluator's same-day fairness across
    models (solvers/evaluator.py:89-101) with days as the batch axis.

    Policy-noise keys are derived from ``seed`` (fold-in, decorrelated from the
    day-generation stream), so stochastic policies get fresh noise per distinct
    seed while every policy inside one call still sees identical keys (paired
    design).  Deterministic policies ignore the keys entirely.
    """
    key = jax.random.PRNGKey(seed)
    env_keys = jax.random.split(key, num_days)
    policy_key = jax.random.fold_in(key, 0x9E3779B9)
    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (num_days,) + x.shape), params)
    reset_fn = jax.jit(jax.vmap(functools.partial(core_reset, config)))
    states0, obs0 = reset_fn(bparams, env_keys, None, None)

    step_fn = jax.vmap(functools.partial(core_step, config))

    results = {}
    for name, policy in policies.items():

        def body(carry, key_t, policy=policy):
            st, ob = carry
            actions = policy(ob, key_t)
            res = step_fn(bparams, st, actions)
            return (res.state, res.obs), res.reward

        @jax.jit
        def rollout(states, obs):
            keys = jax.random.split(policy_key, config.steps_per_day)
            (_, _), rewards = jax.lax.scan(body, (states, obs), keys)
            return rewards.sum(axis=0)

        results[name] = np.asarray(rollout(states0, obs0))
    return results


def evaluate_policy_at_scale(
    config: NanogridConfig,
    params: NanogridParams,
    net_params,
    num_days: int = 10_000,
    batch: int = 4096,
    seed: int = 0,
    algorithm: str = "ppo",
) -> dict[str, float]:
    """Large-scale deterministic-actor evaluation in one jitted program.

    Runs ``num_days`` freshly generated days for each of ``batch`` envs with
    the trained actor (PPO mean action or DDPG actor) closed-loop — the
    reference's evaluate loop (solvers/evaluator.py:13-24) over fresh days.
    Days are a ``lax.scan`` of reset (fresh schedule, battery SoC carried
    from the previous day like the learners' resets) and
    :func:`..core.rollout.fused_day_rollout`.  Day ``d`` of env ``i`` is
    generated from ``fold_in(fold_in(PRNGKey(seed), d), i)``.

    Returns ``{"mean_day_return", "std_day_return", "total_days"}``.
    """
    ret_sum, sq_sum = _at_scale_jit(config, num_days, batch, algorithm)(
        params, net_params, seed)
    total = float(num_days * batch)
    # per-env partial sums are combined in float64 on the host
    mean = float(np.sum(np.asarray(ret_sum, np.float64))) / total
    var = float(np.sum(np.asarray(sq_sum, np.float64))) / total - mean * mean
    return {
        "mean_day_return": mean,
        "std_day_return": float(np.sqrt(max(var, 0.0))),
        "total_days": int(total),
    }


def _deterministic_actor(config: NanogridConfig, algorithm: str, net_params) -> Callable:
    from .networks import ActorCritic, DDPGActor

    low, high = config.action_bounds()
    if algorithm == "ppo":
        net = ActorCritic(action_dim=config.num_actions)
        lo, hi = jnp.asarray(low), jnp.asarray(high)
        return lambda obs, key: jnp.clip(net.apply(net_params, obs)[0], lo, hi)
    if algorithm == "ddpg":
        net = DDPGActor(config.num_actions, tuple(low.tolist()), tuple(high.tolist()))
        return lambda obs, key: net.apply(net_params, obs)
    raise ValueError(f"unknown algorithm {algorithm!r} (expected 'ppo' or 'ddpg')")


@functools.lru_cache(maxsize=32)
def _at_scale_jit(config: NanogridConfig, num_days: int, batch: int,
                  algorithm: str = "ppo"):
    """One compiled evaluation program per (config, days, batch, algorithm) —
    repeated at-scale calls (checkpoint sweeps) reuse it instead of
    re-tracing.  Returns ``run(params, net_params, seed) -> (Σ day return,
    Σ day return²)``, each summed over days per env: shape ``(batch,)``."""
    reset_fn = jax.vmap(functools.partial(core_reset, config))

    def run(params, net_params, seed):
        policy = _deterministic_actor(config, algorithm, net_params)
        bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), params)
        base = jax.random.PRNGKey(seed)
        env_idx = jnp.arange(batch)
        batt0 = jnp.broadcast_to(params.batt_init_soc, (batch,))

        def day(carry, d):
            batt_soc, ret_sum, sq_sum = carry
            k_day = jax.random.fold_in(base, d)
            keys = jax.vmap(lambda i: jax.random.fold_in(k_day, i))(env_idx)
            states, _ = reset_fn(bparams, keys, batt_soc, None)
            states, (_, rewards, _) = fused_day_rollout(config, bparams, states, policy, k_day)
            ret = rewards.sum(axis=0)
            return (states.batt_soc, ret_sum + ret, sq_sum + ret * ret), None

        zero = jnp.zeros((batch,), params.dtype)
        (_, ret_sum, sq_sum), _ = jax.lax.scan(
            day, (batt0, zero, zero), jnp.arange(num_days))
        return ret_sum, sq_sum

    return jax.jit(run)


def predict_single_day(
    config: NanogridConfig,
    params: NanogridParams,
    policy: Callable,
    seed: int = 0,
    schedule=None,
    pv_shift: float | None = None,
) -> tuple[np.ndarray, StepInfo]:
    """Roll one day with a policy; returns (per-step rewards, stacked StepInfo).

    The stacked StepInfo carries every telemetry series the reference dumps to
    ``prediction_results.json`` (envs/smart_nanogrid_environment.py:246-275).
    Policy-noise keys derive from ``seed`` (fold-in), so stochastic policies
    get independent noise per distinct seed.
    """
    key = jax.random.PRNGKey(seed)
    policy_key = jax.random.fold_in(key, 0x9E3779B9)
    state, obs = core_reset(config, params, key, schedule=schedule)
    if pv_shift is not None:
        state = state._replace(pv_shift=jnp.asarray(pv_shift, params.dtype))

    def body(carry, key_t):
        st, ob = carry
        actions = policy(ob, key_t)
        res = core_step(config, params, st, actions)
        return (res.state, res.obs), (res.reward, res.info)

    @jax.jit
    def rollout(state, obs):
        keys = jax.random.split(policy_key, config.steps_per_day)
        (_, _), (rewards, infos) = jax.lax.scan(body, (state, obs), keys)
        return rewards, infos

    rewards, infos = rollout(state, obs)
    return np.asarray(rewards), infos
