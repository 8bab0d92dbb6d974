"""Trajectory-exactness tests: the engine vs the live reference implementation.

The reference (with the minimal Q1/Q7 fixes documented in tests/oracle.py) is run
in-process as the ground-truth oracle.  Both engines are driven from the *same*
recorded day schedule (the reference generates it; we load it via
``schedule_from_arrays``) and the same action sequences; observations, rewards
and telemetry must match to float64 precision (BASELINE.md correctness target).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import oracle
from smart_nanogrid_gym_tpu.core import (
    NanogridConfig,
    make_params,
    schedule_from_arrays,
    step,
    reset,
)

ATOL = 1e-9
RTOL = 1e-9


def make_config(**overrides):
    base = dict(
        price_model=0,
        number_of_chargers=4,
        pv_system_available_in_model=False,
        battery_system_available_in_model=False,
        vehicle_to_everything=False,
        enable_different_vehicle_battery_capacities=True,
        enable_requested_state_of_charge=False,
        time_interval="1h",
        charging_mode="bounded",
        vehicle_uncharged_penalty_mode="sparse",
    )
    base.update(overrides)
    return base


def run_pair(ref_kwargs, actions_per_step, seed=0, pv_shift=1.0):
    """Run the reference and the engine on an identical day; return both trajectories."""
    np.random.seed(seed)
    env = oracle.make_reference_env(**ref_kwargs)
    ref = oracle.run_reference_episode(env, actions_per_step, pv_shift=pv_shift)
    sched_arrays = ref["schedule"]

    config = NanogridConfig.from_reference_kwargs(**ref_kwargs)
    params = make_params(config, dtype=jnp.float64)
    schedule = schedule_from_arrays(
        config,
        soc=sched_arrays["SOC"],
        arrivals=sched_arrays["Arrivals"],
        departures=sched_arrays["Departures"],
        occupancy=sched_arrays["Charger_occupancy"],
        capacities=sched_arrays["Vehicle_capacities"],
        requested_soc=sched_arrays["Requested_SOC"],
    )
    # pv_shift pinned at reset so obs0 sees the shifted radiation lookahead
    # (at 2h the t+3 slot crosses sunrise already at reset)
    state, obs0 = reset(config, params, jax.random.PRNGKey(seed),
                        schedule=schedule, pv_shift=pv_shift)

    observations, rewards, infos = [], [], []
    for actions in actions_per_step:
        res = step(config, params, state, jnp.asarray(actions, jnp.float64))
        observations.append(np.asarray(res.obs))
        rewards.append(float(res.reward))
        infos.append(res.info)
        state = res.state
        if bool(res.done):
            break
    return ref, {"reset_obs": np.asarray(obs0), "observations": observations, "rewards": rewards, "infos": infos}


def assert_trajectories_match(ref, eng, context=""):
    np.testing.assert_allclose(
        eng["reset_obs"], ref["reset_obs"], atol=ATOL, rtol=RTOL,
        err_msg=f"{context}: reset observation mismatch",
    )
    assert len(eng["observations"]) == len(ref["observations"])
    for i, (o_ref, o_eng) in enumerate(zip(ref["observations"], eng["observations"])):
        np.testing.assert_allclose(
            o_eng, o_ref, atol=ATOL, rtol=RTOL, err_msg=f"{context}: obs mismatch at step {i}"
        )
    np.testing.assert_allclose(
        eng["rewards"], ref["rewards"], atol=ATOL, rtol=RTOL,
        err_msg=f"{context}: reward mismatch",
    )


def random_actions(num_steps, dim, seed, low=-1.0, high=1.0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(low, high, size=dim) for _ in range(num_steps)]


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty_mode", ["no_penalty", "on_departure", "sparse", "dense"])
def test_basic_zero_actions(penalty_mode):
    kw = make_config(vehicle_uncharged_penalty_mode=penalty_mode)
    actions = [np.zeros(4)] * 24
    ref, eng = run_pair(kw, actions, seed=11)
    assert_trajectories_match(ref, eng, f"basic/{penalty_mode}/zero")


@pytest.mark.parametrize("penalty_mode", ["on_departure", "sparse", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_basic_random_actions(penalty_mode, seed):
    kw = make_config(vehicle_uncharged_penalty_mode=penalty_mode)
    actions = random_actions(24, 4, seed + 100, low=0.0, high=1.0)  # non-v2x: actions >= 0
    ref, eng = run_pair(kw, actions, seed=seed)
    assert_trajectories_match(ref, eng, f"basic/{penalty_mode}/random/{seed}")


@pytest.mark.parametrize("seed", [3, 4])
def test_b_pv_random_actions(seed):
    kw = make_config(
        pv_system_available_in_model=True,
        battery_system_available_in_model=True,
    )
    # chargers in [0, 1], battery in [-1, 1] (env.py:101-110)
    rng = np.random.RandomState(seed + 7)
    actions = [np.concatenate([rng.uniform(0, 1, 4), rng.uniform(-1, 1, 1)]) for _ in range(24)]
    ref, eng = run_pair(kw, actions, seed=seed, pv_shift=1.25)
    assert_trajectories_match(ref, eng, f"b-pv/{seed}")


@pytest.mark.parametrize("seed", [5])
def test_v2x_random_actions(seed):
    kw = make_config(vehicle_to_everything=True)
    # v2x without PV: negative total demand triggers the reference breakpoint()
    # (SURVEY.md Q4), so keep discharging mild enough not to flip the sign.
    rng = np.random.RandomState(seed)
    actions = [rng.uniform(-0.1, 1.0, 4) for _ in range(24)]
    ref, eng = run_pair(kw, actions, seed=seed)
    assert_trajectories_match(ref, eng, f"v2x/{seed}")


def test_v2x_b_pv_random_actions():
    kw = make_config(
        vehicle_to_everything=True,
        pv_system_available_in_model=True,
        battery_system_available_in_model=True,
        number_of_chargers=8,
    )
    rng = np.random.RandomState(42)
    actions = [rng.uniform(-0.05, 1.0, 9) for _ in range(24)]
    ref, eng = run_pair(kw, actions, seed=9, pv_shift=0.8)
    assert_trajectories_match(ref, eng, "v2x-b-pv")


def test_requested_soc_and_uniform_capacities():
    kw = make_config(
        enable_requested_state_of_charge=True,
        enable_different_vehicle_battery_capacities=False,
    )
    actions = random_actions(24, 4, 55, low=0.0, high=1.0)
    ref, eng = run_pair(kw, actions, seed=6)
    assert_trajectories_match(ref, eng, "requested-soc")


def test_price_models_match():
    for model in (1, 2, 3, 4):
        kw = make_config(price_model=model)
        actions = random_actions(6, 4, model, low=0.0, high=1.0)
        ref, eng = run_pair(kw, actions, seed=20 + model)
        assert_trajectories_match(ref, eng, f"price-model-{model}")


def test_two_hour_interval():
    kw = make_config(time_interval="2h")
    actions = random_actions(12, 4, 77, low=0.0, high=1.0)
    ref, eng = run_pair(kw, actions, seed=13)
    assert_trajectories_match(ref, eng, "2h-interval")


def test_telemetry_matches_reference_series():
    """Per-step info fields must match the telemetry series the reference env
    accumulates (envs/smart_nanogrid_environment.py:143-171)."""
    kw = make_config(
        pv_system_available_in_model=True,
        battery_system_available_in_model=True,
    )
    rng = np.random.RandomState(3)
    actions = [np.concatenate([rng.uniform(0, 1, 4), rng.uniform(-1, 1, 1)]) for _ in range(24)]
    np.random.seed(21)
    env = oracle.make_reference_env(**kw)
    ref = oracle.run_reference_episode(env, actions, pv_shift=1.0)
    sched_arrays = ref["schedule"]

    config = NanogridConfig.from_reference_kwargs(**kw)
    params = make_params(config, dtype=jnp.float64)
    schedule = schedule_from_arrays(
        config,
        soc=sched_arrays["SOC"],
        arrivals=sched_arrays["Arrivals"],
        departures=sched_arrays["Departures"],
        occupancy=sched_arrays["Charger_occupancy"],
        capacities=sched_arrays["Vehicle_capacities"],
        requested_soc=sched_arrays["Requested_SOC"],
    )
    state, _ = reset(config, params, jax.random.PRNGKey(0), schedule=schedule)
    state = state._replace(pv_shift=jnp.asarray(1.0, jnp.float64))

    infos = []
    for a in actions:
        res = step(config, params, state, jnp.asarray(a, jnp.float64))
        state = res.state
        infos.append(res.info)

    series_pairs = {
        "total_cost": env.total_cost_per_timestep,
        "grid_energy_cost": env.grid_energy_cost_per_timestep,
        "grid_energy": env.grid_energy_per_timestep,
        "grid_power": env.grid_power_per_timestep,
        "utilized_solar_energy": env.solar_energy_utilization_per_timestep,
        "total_penalty": env.total_penalty_per_timestep,
        "total_battery_penalty": env.total_battery_penalty_per_timestep,
        "battery_soc_below_dod_penalty": env.battery_soc_below_dod_penalty_per_timestep,
        "total_vehicle_penalty": env.total_vehicle_penalty_per_timestep,
        "insufficiently_charged_vehicles_penalty": env.insufficiently_charged_vehicle_penalty_per_timestep,
        "battery_action": env.battery_action_per_timestep,
        "total_charging_power": env.total_charging_power_per_timestep,
        "total_discharging_power": env.total_discharging_power_per_timestep,
        "charger_power_values": env.charger_power_values_per_timestep,
        "battery_power_value": env.battery_power_value_per_timestep,
        "battery_calculated_power_value": env.battery_calculated_power_value_per_timestep,
        "battery_state_of_charge": env.battery_per_timestep,
        "discharging_nonexistent_vehicles_penalty": env.dis_charging_nonexistent_vehicles_penalty_per_timestep,
        "overcharged_vehicles_penalty": env.overcharged_vehicle_penalty_per_timestep,
        "over_discharged_vehicles_penalty": env.over_discharged_vehicle_penalty_per_timestep,
        "needlessly_charged_vehicles_penalty": env.needlessly_charged_vehicle_penalty_per_timestep,
        "low_resource_utilisation_penalty": env.low_resource_utilisation_penalty_per_timestep,
        "battery_overcharging_penalty": env.battery_overcharging_penalty_per_timestep,
        "battery_over_discharging_penalty": env.battery_over_discharging_penalty_per_timestep,
    }
    for field, ref_series in series_pairs.items():
        eng_series = [np.asarray(getattr(info, field)) for info in infos]
        np.testing.assert_allclose(
            np.asarray(eng_series, dtype=np.float64),
            np.asarray(ref_series, dtype=np.float64),
            atol=ATOL, rtol=RTOL, err_msg=f"telemetry series {field!r} mismatch",
        )
