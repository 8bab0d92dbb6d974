"""``evaluate_policy_at_scale`` against a direct rollout of the same days.

The direct side steps ``core/transition.step`` one step at a time over the
days the evaluator documents: day ``d`` of env ``i`` generated from
``fold_in(fold_in(PRNGKey(seed), d), i)``, battery SoC carried from one day to
the next, the deterministic actor in the loop.  Both sides run in float64, so
they agree to rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.core.transition import reset as core_reset, step as core_step
from smart_nanogrid_gym_tpu.solvers.evaluator import evaluate_policy_at_scale
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic, DDPGActor
from smart_nanogrid_gym_tpu.tools.train_ppo import VARIANTS

DAYS, BATCH, SEED = 3, 6, 11


def _actor(config, algorithm):
    low, high = config.action_bounds()
    if algorithm == "ppo":
        net = ActorCritic(action_dim=config.num_actions)
        params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, config.obs_dim)))
        # a trained-looking policy: scale the 0.01-gain head up so actions
        # spread over the box instead of sitting at its centre
        params["params"]["pi"]["Dense_2"]["kernel"] *= 100.0
        act = lambda obs: jnp.clip(net.apply(params, obs)[0], low, high)
    else:
        net = DDPGActor(config.num_actions, tuple(low.tolist()), tuple(high.tolist()))
        params = net.init(jax.random.PRNGKey(5), jnp.zeros((1, config.obs_dim)))
        act = lambda obs: net.apply(params, obs)
    return params, act


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("algorithm", ["ppo", "ddpg"])
def test_at_scale_matches_direct_same_days_rollout(algorithm, variant):
    config = NanogridConfig(num_chargers=4, **VARIANTS[variant])
    params = make_params(config, dtype=jnp.float64)
    net_params, act = _actor(config, algorithm)

    got = evaluate_policy_at_scale(config, params, net_params, num_days=DAYS,
                                   batch=BATCH, seed=SEED, algorithm=algorithm)

    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (BATCH,) + x.shape), params)
    reset = jax.jit(jax.vmap(functools.partial(core_reset, config)))
    step = jax.jit(jax.vmap(functools.partial(core_step, config)))
    batt = jnp.broadcast_to(params.batt_init_soc, (BATCH,))
    returns = []
    for d in range(DAYS):
        k_day = jax.random.fold_in(jax.random.PRNGKey(SEED), d)
        keys = jnp.stack([jax.random.fold_in(k_day, i) for i in range(BATCH)])
        state, obs = reset(bparams, keys, batt, None)
        ret = np.zeros(BATCH)
        for _ in range(config.steps_per_day):
            res = step(bparams, state, act(obs))
            state, obs = res.state, res.obs
            ret += np.asarray(res.reward)
        batt = state.batt_soc
        returns.append(ret)
    returns = np.concatenate(returns)

    assert got["total_days"] == DAYS * BATCH
    np.testing.assert_allclose(got["mean_day_return"], returns.mean(), rtol=1e-9)
    np.testing.assert_allclose(got["std_day_return"], returns.std(), rtol=1e-6)
    assert returns.std() > 0
