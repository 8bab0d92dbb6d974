"""Single-env Gymnasium-style adapter reproducing the reference API surface.

Drop-in replacement for the reference ``SmartNanogridEnv``
(envs/smart_nanogrid_environment.py): same ctor kwargs, same 5-tuple ``step``
return, same ``reset(generate_new_initial_values=..., algorithm_used=...,
environment_mode=...)`` kwargs, same observation/action spaces, the same
28-series telemetry accumulation and day-end JSON dumps with
reference-compatible keys and file names (with POSIX path separators — the
reference's Windows-only '\\\\' concatenation, SURVEY.md Q7, is fixed here).

The BESS state of charge persists across ``reset`` calls, matching the
reference where the CMS constructs the battery once per env (SURVEY.md §3.1).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

try:  # gymnasium is optional; the adapter degrades to a plain duck-typed env
    import gymnasium
    from gymnasium import spaces as gym_spaces

    _GYM_BASE = gymnasium.Env
except ImportError:  # pragma: no cover
    gymnasium = None
    gym_spaces = None
    _GYM_BASE = object

from ..core import NanogridConfig, make_params
from ..core.generate import load_initial_values_json, schedule_to_json_dict
from ..core.transition import reset as core_reset, step as core_step

# The 28 telemetry series accumulated per step (reference env.py:143-171) and
# their keys in prediction_results.json (reference env.py:246-275).
_SERIES_TO_JSON = {
    "grid_power": "Grid_power",
    "grid_energy": "Grid_energy",
    "utilized_solar_energy": "Utilized_solar_energy",
    "total_vehicle_penalty": "Total_vehicle_penalties",
    "total_battery_penalty": "Total_battery_penalties",
    "total_penalty": "Total_penalties",
    "total_cost": "Total_cost",
    "battery_state_of_charge": "Battery_state_of_charge",
    "grid_energy_cost": "Grid_energy_cost",
    "battery_action": "Battery_action",
    "charger_actions": "Charger_actions",
    "total_charging_power": "Total_charging_power",
    "total_discharging_power": "Total_discharging_power",
    "charger_power_values": "Charger_power_values",
    "battery_power_value": "Battery_power_value",
    "battery_soc_below_dod_penalty": "Battery_SOC_below_DoD_penalties",
    "low_resource_utilisation_penalty": "Low_resource_utilisation_penalties",
    "battery_overcharging_penalty": "Battery_overcharging_penalties",
    "battery_over_discharging_penalty": "Battery_over_discharging_penalties",
    "insufficiently_charged_vehicles_penalty": "Insufficiently_charged_vehicle_penalties",
    "needlessly_charged_vehicles_penalty": "Needlessly_charged_vehicle_penalties",
    "overcharged_vehicles_penalty": "Overcharged_vehicle_penalties",
    "over_discharged_vehicles_penalty": "Over_discharged_vehicle_penalties",
    "battery_calculated_power_value": "Battery_calculated_power_value",
    "discharging_nonexistent_vehicles_penalty": "DisCharging_nonexistent_vehicles_penalties",
}


class SmartNanogridEnv(_GYM_BASE):
    """Reference-compatible single-env wrapper around the batched engine."""

    metadata = {"render_modes": []}

    def __init__(
        self,
        price_model=0,
        number_of_chargers=8,
        pv_system_available_in_model=True,
        battery_system_available_in_model=True,
        vehicle_to_everything=False,
        enable_different_vehicle_battery_capacities=True,
        enable_requested_state_of_charge=False,
        algorithm_used="",
        environment_mode="",
        time_interval="",
        charging_mode="bounded",
        vehicle_uncharged_penalty_mode="sparse",
        output_directory=None,
        seed=0,
        dtype=jnp.float32,
    ):
        self.config = NanogridConfig.from_reference_kwargs(
            price_model=price_model,
            number_of_chargers=number_of_chargers,
            pv_system_available_in_model=pv_system_available_in_model,
            battery_system_available_in_model=battery_system_available_in_model,
            vehicle_to_everything=vehicle_to_everything,
            enable_different_vehicle_battery_capacities=enable_different_vehicle_battery_capacities,
            enable_requested_state_of_charge=enable_requested_state_of_charge,
            time_interval=time_interval,
            charging_mode=charging_mode,
            vehicle_uncharged_penalty_mode=vehicle_uncharged_penalty_mode,
        )
        self.params = make_params(self.config, dtype=dtype)
        self.algorithm_used = algorithm_used
        self.environment_mode = environment_mode
        self.requested_time_interval = time_interval
        self.charging_mode = charging_mode
        self.penalty_mode_name = vehicle_uncharged_penalty_mode
        self.output_directory = output_directory

        self._key = jax.random.PRNGKey(seed)
        self._state = None
        self._batt_soc_carry = None  # persists across resets (reference quirk)
        self._telemetry = {name: [] for name in _SERIES_TO_JSON}
        self._initial_battery = 0.0

        self._jit_reset = jax.jit(lambda p, k, b, s: core_reset(self.config, p, k, b, s))
        self._jit_step = jax.jit(lambda p, st, a: core_step(self.config, p, st, a))

        cfg = self.config
        self.observation_space, self.action_space = self._build_spaces(cfg)

    @staticmethod
    def _build_spaces(cfg: NanogridConfig):
        """Spaces per reference envs/smart_nanogrid_environment.py:98-120."""
        if gym_spaces is None:
            return None, None
        obs_low = np.zeros(cfg.obs_dim, dtype=np.float32)
        obs_high = np.ones(cfg.obs_dim, dtype=np.float32)
        observation_space = gym_spaces.Box(low=obs_low, high=obs_high, dtype=np.float32)
        a_low, a_high = cfg.action_bounds()
        action_space = gym_spaces.Box(low=a_low, high=a_high, shape=a_low.shape, dtype=np.float32)
        return observation_space, action_space

    # ------------------------------------------------------------------ API --

    def reset(
        self,
        seed=None,
        options=None,
        generate_new_initial_values=True,
        algorithm_used="",
        environment_mode="",
        initial_values_path=None,
        **_kwargs,
    ):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
            if gymnasium is not None:
                super().reset(seed=seed)  # seeds gymnasium's np_random bookkeeping
        self.algorithm_used = algorithm_used or self.algorithm_used
        self.environment_mode = environment_mode or self.environment_mode

        for series in self._telemetry.values():
            series.clear()

        schedule = None
        if not generate_new_initial_values:
            path = initial_values_path or self._initial_values_path()
            schedule = load_initial_values_json(path, self.config, dtype=np.asarray(self.params.price).dtype)

        self._key, sub = jax.random.split(self._key)
        state, obs = self._jit_reset(self.params, sub, self._batt_soc_carry, schedule)
        self._state = state
        self._initial_battery = float(state.batt_soc) if self.config.battery_system else 0.0

        if generate_new_initial_values:
            self._save_initial_values()
        return np.asarray(obs), {}

    def step(self, actions):
        actions = np.asarray(actions, dtype=np.float64)
        if actions.shape != (self.config.num_actions,):
            # The reference silently slices oversized vectors
            # (central_management_system.py:85-89); be explicit at the API edge.
            raise ValueError(
                f"expected {self.config.num_actions} actions, got shape {actions.shape}"
            )
        actions = jnp.asarray(actions)
        res = self._jit_step(self.params, self._state, actions)
        self._state = res.state
        self._batt_soc_carry = res.state.batt_soc

        info_dict = res.info._asdict()
        for name, series in self._telemetry.items():
            val = np.asarray(info_dict[name])
            series.append(val.tolist() if val.ndim else float(val))
        self._initial_battery = float(res.info.initial_battery_state_of_charge)

        done = bool(res.done)
        if done:
            self._save_prediction_results()
        return np.asarray(res.obs), float(res.reward), done, False, {}

    def render(self, mode="human"):
        pass

    def seed(self, seed=None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)

    def close(self):
        pass

    # ----------------------------------------------------------- file IO -----

    def _out_dir(self):
        base = self.output_directory or os.path.join(os.getcwd(), "nanogrid_outputs")
        # Mirrors reference environment_mode -> directory routing (env.py:289-296).
        mode_dir = {
            "training": "training_files",
            "evaluation": "evaluation_files",
            "prediction": "single_prediction_files",
        }.get(self.environment_mode, "")
        path = os.path.join(base, "RL", mode_dir) if mode_dir else base
        os.makedirs(path, exist_ok=True)
        return path

    def _file_name_root(self):
        """Reference file naming: {ALGO}-{variant}-{mode}-{penalty}-{N}ch-{Δt}
        (env.py:300-303)."""
        cfg = self.config
        return (
            f"{self.algorithm_used}-{cfg.variant_name}-{self.charging_mode}-"
            f"{self.penalty_mode_name}-{cfg.num_chargers}ch-{self.requested_time_interval}"
        )

    def _initial_values_path(self):
        base = self.output_directory or os.path.join(os.getcwd(), "nanogrid_outputs")
        os.makedirs(base, exist_ok=True)
        return os.path.join(base, "initial_values.json")

    def _save_initial_values(self):
        payload = schedule_to_json_dict(self._state.schedule, self.config)
        with open(self._initial_values_path(), "w") as fp:
            json.dump(payload, fp, indent=4)

    def _save_prediction_results(self):
        """Day-end telemetry dump with reference-compatible keys (env.py:239-309)."""
        cfg = self.config
        if cfg.pv_system:
            # Available_solar_energy is the *unshifted* padded trace
            # (pv_system_manager.py:75-76): power · Δt over 2 padded days.
            solar_energy = (np.asarray(self.params.solar_power) * cfg.time_interval).reshape(1, -1).tolist()
        else:
            solar_energy = []
        results = {"SOC": np.asarray(self._state.soc).tolist()}
        for name, json_key in _SERIES_TO_JSON.items():
            results[json_key] = self._telemetry[name]
        results["Available_solar_energy"] = solar_energy
        results["Initial_battery_state_of_charge"] = self._initial_battery

        out_dir = self._out_dir()
        with open(os.path.join(out_dir, "prediction_results.json"), "w") as fp:
            json.dump(results, fp, indent=4)
        name = self._file_name_root()
        with open(os.path.join(out_dir, f"{name}-prediction_results.json"), "w") as fp:
            json.dump(results, fp, indent=4)
        with open(os.path.join(out_dir, f"{name}-initial_values.json"), "w") as fp:
            json.dump(schedule_to_json_dict(self._state.schedule, self.config), fp, indent=4)
