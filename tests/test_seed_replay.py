"""End-to-end seed replay: identical trajectories vs the reference from a bare
integer seed (BASELINE.md north-star correctness target).

The chain: np.random.seed(s) drives the reference's generation; the native
MT19937 generator replays the identical stream; the JAX engine consumes the
resulting schedule and must reproduce the reference's observations and rewards
step for step.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import oracle
from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.core.generate import schedule_from_reference_seed
from smart_nanogrid_gym_tpu.core.transition import reset, step


@pytest.mark.parametrize("seed", [0, 17, 424242])
@pytest.mark.parametrize("variant", ["basic", "b-pv"])
def test_trajectory_replay_from_seed(seed, variant):
    kw = dict(
        price_model=0, number_of_chargers=4,
        pv_system_available_in_model=variant == "b-pv",
        battery_system_available_in_model=variant == "b-pv",
        vehicle_to_everything=False,
        enable_different_vehicle_battery_capacities=True,
        enable_requested_state_of_charge=False,
        time_interval="1h", charging_mode="bounded",
        vehicle_uncharged_penalty_mode="sparse",
    )
    n_act = 4 + (1 if variant == "b-pv" else 0)
    rng = np.random.RandomState(seed + 1)
    actions = [rng.uniform(0, 1, n_act) for _ in range(24)]

    # reference: generation consumes the global numpy stream seeded with `seed`
    np.random.seed(seed)
    env = oracle.make_reference_env(**kw)
    ref = oracle.run_reference_episode(env, actions, pv_shift=1.0)

    # engine: schedule reconstructed from the bare seed, no recorded data
    config = NanogridConfig.from_reference_kwargs(**kw)
    params = make_params(config, dtype=jnp.float64)
    schedule = schedule_from_reference_seed(seed, config)
    state, obs0 = reset(config, params, jax.random.PRNGKey(0), schedule=schedule)
    state = state._replace(pv_shift=jnp.asarray(1.0, jnp.float64))

    np.testing.assert_allclose(np.asarray(obs0), ref["reset_obs"], rtol=1e-9, atol=1e-9)
    for i, a in enumerate(actions):
        res = step(config, params, state, jnp.asarray(a, jnp.float64))
        state = res.state
        np.testing.assert_allclose(
            np.asarray(res.obs), ref["observations"][i], rtol=1e-9, atol=1e-9,
            err_msg=f"seed-replay obs mismatch at step {i}",
        )
        np.testing.assert_allclose(float(res.reward), ref["rewards"][i], rtol=1e-9)
