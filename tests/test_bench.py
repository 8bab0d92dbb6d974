"""bench.py's headline at tiny size on the CPU: generation + the fused XLA day
with the RBC policy gives the day returns of 24 sequential ``transition.step``
calls on the same generated days."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import bench
import chip_smoke
from smart_nanogrid_gym_tpu.core import make_params
from smart_nanogrid_gym_tpu.core.transition import reset as core_reset, step as core_step
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn

BATCH, DAYS = 8, 2


def test_headline_day_loop_matches_sequential_steps():
    config = chip_smoke.reference_config()
    with jax.enable_x64(False):
        params = make_params(config, dtype=jnp.float32)
        rbc = make_rbc_policy_fn(config)
        got = bench.day_loop(config, params, lambda ob, k: rbc(ob), DAYS, BATCH)(3)

        bparams = chip_smoke.broadcast(params, BATCH)
        reset = jax.vmap(functools.partial(core_reset, config))
        step = jax.jit(jax.vmap(functools.partial(core_step, config)))
        returns = []
        for j in range(DAYS):
            keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 3 * 997 + j), BATCH)
            state, obs = reset(bparams, keys, None, None)
            total = jnp.zeros(BATCH)
            for _ in range(config.steps_per_day):
                res = step(bparams, state, rbc(obs))
                state, obs, total = res.state, res.obs, total + res.reward
            returns.append(total.mean())
    np.testing.assert_allclose(float(got), float(np.mean(returns)), rtol=1e-5)
    assert bench.bench_rbc_days(config, params, days=1, batch=BATCH) > 0
