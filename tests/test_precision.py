"""The f32 engine against the float64 plain reference.

Users run the fused day rollout in float32.  Here it is stepped next to
``core/transition.step`` in float64, teacher-forced with the f32 run's actions
(``chip_smoke.f64_teacher_forced``), over every model variant and penalty
mode.  ``chip_smoke.rollout_deviation`` raises past the tolerances
``chip_smoke.py`` holds the GPU run to (``REWARD_RTOL``/``REWARD_ATOL``,
``OBS_ATOL``), so this test pins them: they are what float32 arithmetic alone
costs on this program, with the reasons given beside them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.core.rollout import fused_day_rollout
from smart_nanogrid_gym_tpu.core.transition import reset as core_reset
from smart_nanogrid_gym_tpu.tools.train_ppo import VARIANTS

B = 16
PENALTY_MODES = ("no_penalty", "on_departure", "sparse", "dense")


@pytest.mark.parametrize("penalty_mode", PENALTY_MODES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_f32_rollout_within_tolerance_of_f64_step(variant, penalty_mode):
    config = NanogridConfig(num_chargers=8, penalty_mode=penalty_mode, **VARIANTS[variant])
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(False):
        bparams = chip_smoke.broadcast(make_params(config, dtype=jnp.float32), B)
        keys = jax.random.split(jax.random.PRNGKey(7), B)
        states, _ = jax.vmap(functools.partial(core_reset, config))(bparams, keys, None, None)
        low, high = (jnp.asarray(b) for b in config.action_bounds())

        # actions spread over the whole box (v2x included), element-wise from
        # the observation so the policy itself adds no reduction noise
        def policy(obs, key):
            u = (obs[..., : config.num_actions] * 7.31 + 0.173) % 1.0
            a = low + u * (high - low)
            return a, a

        _, (obs, rewards, _, actions) = jax.jit(
            lambda p, s: fused_day_rollout(config, p, s, policy, jax.random.PRNGKey(1),
                                           policy_aux=True))(bparams, states)
        assert rewards.dtype == jnp.float32 and obs.dtype == jnp.float32

    dev = chip_smoke.rollout_deviation(
        config, chip_smoke.first(states, B), np.asarray(actions), np.asarray(rewards),
        np.asarray(obs), cpu)
    assert len(dev["max_abs_dreward_per_step"]) == config.steps_per_day
