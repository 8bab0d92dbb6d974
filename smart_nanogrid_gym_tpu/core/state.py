"""Environment state pytrees.

The reference keeps its day state scattered across Python objects — per-charger
``zeros(25)`` arrays (utils/charger.py:16-19), list-of-list arrival/departure
schedules (utils/charging_station.py:21-26), and scalar BESS fields
(utils/battery_energy_storage_system.py:6-22).  This build collapses all of
it into two struct-of-arrays pytrees:

- :class:`DaySchedule` — the immutable per-day tables, **precomputed** at
  generation/load time.  In particular the reference's per-step Python searches
  (``calculate_departure_times`` charging_station.py:92-112, the departing-soon
  checks :79-90) become dense ``(N, L)`` lookup tables.
- :class:`EnvState` — the mutable per-step carry (time, SoC history, battery
  SoC, PV shift, RNG key).

Shapes: ``N`` = num_chargers, ``L`` = table_len = steps_per_day + 1 (the extra
column replicates the reference's ``zeros(25)`` arrays whose index ``t-1`` wraps
to the last, always-zero column at t=0 — SURVEY.md Q2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class DaySchedule(NamedTuple):
    """Precomputed day schedule for all chargers of one env."""

    occupancy: jnp.ndarray        # (N, L) 1.0 where a vehicle is plugged in [arrival, departure)
    capacity: jnp.ndarray         # (N, L) vehicle battery capacity [kWh] while occupied
    requested_soc: jnp.ndarray    # (N, L) requested end SoC while occupied (1.0 if disabled)
    soc_init: jnp.ndarray         # (N, L) generation-time SoC array (arrival SoCs at arrival steps)
    is_arrival: jnp.ndarray       # (N, L) 1.0 at vehicle-arrival timesteps
    dep_obs: jnp.ndarray          # (N, L) next_departure - t while occupied, else 0
    mask_departing: jnp.ndarray   # (N, L) occupied & departure == t+1 (on_departure mode)
    mask_departing3: jnp.ndarray  # (N, L) occupied & departure <= t+3 (sparse mode; the
    #                                reference hardcodes 3 regardless of n — SURVEY.md Q10)


class EnvState(NamedTuple):
    """Mutable environment state (the ``lax.scan`` carry)."""

    t: jnp.ndarray              # i32 current timestep within the day
    soc: jnp.ndarray            # (N, L) running SoC history (mirrors charger.vehicle_state_of_charge)
    schedule: DaySchedule
    batt_soc: jnp.ndarray       # scalar BESS state of charge
    batt_init_soc: jnp.ndarray  # BESS SoC at day start (battery_energy_storage_system.py:24-25)
    pv_shift: jnp.ndarray       # random PV shift ratio (smart_nanogrid_environment.py:181,349)
    pmask: jnp.ndarray          # (N,) penalty-check mask computed by the *trailing
    #                             observe* of the previous step — the reference's
    #                             ``_penalty_check_vehicles`` side effect
    #                             (charging_station.py:42-63); consumed by the next
    #                             step and carried across day rollovers (Q8)
    key: jnp.ndarray            # PRNG key for day-end PV-shift redraws
    day: jnp.ndarray            # i32 day counter (RNG folding for schedule regeneration)


class StepInfo(NamedTuple):
    """Per-step telemetry, mirroring the 24-key results dict the reference CMS
    returns (utils/central_management_system.py:128-155).  Under ``lax.scan``
    these stack into the 28 per-timestep series the reference env accumulates
    (envs/smart_nanogrid_environment.py:143-171)."""

    total_cost: jnp.ndarray
    grid_energy_cost: jnp.ndarray
    grid_energy: jnp.ndarray
    grid_power: jnp.ndarray
    utilized_solar_energy: jnp.ndarray
    total_penalty: jnp.ndarray
    total_battery_penalty: jnp.ndarray
    battery_soc_below_dod_penalty: jnp.ndarray
    battery_overcharging_penalty: jnp.ndarray
    battery_over_discharging_penalty: jnp.ndarray
    low_resource_utilisation_penalty: jnp.ndarray
    total_vehicle_penalty: jnp.ndarray
    insufficiently_charged_vehicles_penalty: jnp.ndarray
    needlessly_charged_vehicles_penalty: jnp.ndarray
    overcharged_vehicles_penalty: jnp.ndarray
    over_discharged_vehicles_penalty: jnp.ndarray
    battery_action: jnp.ndarray
    charger_actions: jnp.ndarray            # (N,)
    total_charging_power: jnp.ndarray
    total_discharging_power: jnp.ndarray
    charger_power_values: jnp.ndarray       # (N,)
    battery_power_value: jnp.ndarray
    battery_calculated_power_value: jnp.ndarray
    battery_state_of_charge: jnp.ndarray
    initial_battery_state_of_charge: jnp.ndarray
    discharging_nonexistent_vehicles_penalty: jnp.ndarray
