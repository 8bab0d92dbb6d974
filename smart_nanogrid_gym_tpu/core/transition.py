"""The pure environment transition: ``reset`` / ``observe`` / ``step``.

This is the batched, jittable replacement for the entire reference call stack
``SmartNanogridEnv.step → CentralManagementSystem.manage_nanogrid →
{ChargingStation, BatteryEnergyStorageSystem, PVSystemManager, Accountant,
Penaliser}`` (SURVEY.md §3.3).  One call = one fused XLA program; no Python
control flow on traced values; ``vmap`` adds the env-batch axis and ``lax.scan``
rolls full days.

Exactness-critical ordering replicated from the reference:

- the returned observation is computed **before** the timestep increment
  (envs/smart_nanogrid_environment.py:173-174), so obs after action aₜ exposes
  soc[t] *post-update* and departures relative to t;
- the vehicle penalty-check set used at step t is the one computed by the
  *trailing observe of the previous step*, i.e. the mask of timestep
  ``max(t-1, 0)`` ([verified at runtime] — ChargingStation.simulate runs inside
  ``observe`` at the still-old timestep, charging_station.py:34-40, and its
  ``_penalty_check_vehicles`` side effect is consumed by the *next* step's
  ``manage_nanogrid``, central_management_system.py:97);
- the penaliser reads SoC/requested-SoC at index ``(t-1) mod L`` — the dead
  arrival-membership check always falls through to ``timestep - 1`` with
  Python's negative-index wraparound (utils/penaliser.py:59-69, SURVEY.md Q2);
- day completion resets the timestep and redraws the PV shift but keeps the
  schedule and battery SoC (envs/smart_nanogrid_environment.py:176-181,
  SURVEY.md Q8); the new PV shift is drawn *after* the observation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import physics
from .config import NanogridConfig, PenaltyMode
from .generate import generate_schedule
from .params import NanogridParams
from .state import DaySchedule, EnvState, StepInfo


def _col(table: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Column t of an (N, L) table, t traced."""
    return jax.lax.dynamic_index_in_dim(table, t, axis=1, keepdims=False)


def _window(vec: jnp.ndarray, start: jnp.ndarray, size: int) -> jnp.ndarray:
    return jax.lax.dynamic_slice_in_dim(vec, start, size)


def _penalty_mask_table(config: NanogridConfig, schedule: DaySchedule) -> jnp.ndarray:
    """Static selection of the penalty-check mask table
    (reference: charging_station.py:50-60)."""
    if config.penalty_mode == PenaltyMode.NO_PENALTY:
        return jnp.zeros_like(schedule.occupancy)
    if config.penalty_mode == PenaltyMode.ON_DEPARTURE:
        return schedule.mask_departing
    if config.penalty_mode == PenaltyMode.SPARSE:
        return schedule.mask_departing3
    return schedule.occupancy  # DENSE


def observe(config: NanogridConfig, params: NanogridParams, state: EnvState) -> jnp.ndarray:
    """Observation assembly (reference: envs/smart_nanogrid_environment.py:190-231).

    Layout (verified at runtime, SURVEY.md §3.2):
    ``[rad(t)·shift, price(t), rad_pred(t+1..t+3)·shift, price_pred(t+1..t+3),
    soc_1..N, dep_1..N / 24, battery_soc]`` with the PV terms dropped when no PV
    system and the battery term dropped when no BESS.
    """
    t = state.t
    k = config.lookahead

    price_now = params.price_norm[t]
    price_pred = _window(params.price_norm, t + 1, k)

    soc_obs = _col(state.soc, t)
    dep_obs = _col(state.schedule.dep_obs, t) / 24.0  # always /24 (env.py:207-208)

    parts = []
    if config.pv_system:
        rad_now = params.rad_norm[t] * state.pv_shift
        rad_pred = _window(params.rad_norm, t + 1, k) * state.pv_shift
        parts += [rad_now[None], price_now[None], rad_pred, price_pred]
    else:
        parts += [price_now[None], price_pred]
    parts += [soc_obs, dep_obs]
    if config.battery_system:
        parts += [state.batt_soc[None]]

    obs = jnp.concatenate(parts)
    if config.cast_obs_to_f32:
        obs = obs.astype(jnp.float32)
    return obs


def reset(
    config: NanogridConfig,
    params: NanogridParams,
    key: jnp.ndarray,
    batt_soc: jnp.ndarray | None = None,
    schedule: DaySchedule | None = None,
    day: int | jnp.ndarray = 0,
    pv_shift: jnp.ndarray | float | None = None,
) -> tuple[EnvState, jnp.ndarray]:
    """Start a new day (reference: envs/smart_nanogrid_environment.py:311-351).

    ``batt_soc`` lets callers carry the BESS state across episodes — the
    reference never resets it (the CMS constructs the BESS once; SURVEY.md §3.1)
    — and ``schedule`` replays a recorded day (reset with
    ``generate_new_initial_values=False``, charging_station.py:119-136).
    ``pv_shift`` pins the PV shift ratio instead of drawing it (needed to
    replay a recorded reference day exactly: the reset observation already
    exposes shifted radiation through the lookahead window, §3.2).
    """
    dtype = params.dtype
    k_sched, k_shift, k_next = jax.random.split(key, 3)
    if schedule is None:
        schedule = generate_schedule(k_sched, config, params)
    if batt_soc is None:
        batt_soc = params.batt_init_soc
    batt_soc = jnp.asarray(batt_soc, dtype)
    # random_pv_shift_ratio = randint(0, 180)/100 (env.py:349); stdlib randint is
    # inclusive of both ends.
    if pv_shift is None:
        pv_shift = jax.random.randint(k_shift, (), 0, 181).astype(dtype) / 100.0
    else:
        pv_shift = jnp.asarray(pv_shift, dtype)

    state = EnvState(
        t=jnp.asarray(0, jnp.int32),
        soc=schedule.soc_init,
        schedule=schedule,
        batt_soc=batt_soc,
        batt_init_soc=batt_soc,
        pv_shift=pv_shift,
        # reset's observe() runs ChargingStation.simulate at t=0, computing the
        # penalty-check set the first step will consume (SURVEY.md §3.1).
        pmask=_penalty_mask_table(config, schedule)[:, 0],
        key=k_next,
        day=jnp.asarray(day, jnp.int32),
    )
    return state, observe(config, params, state)


class StepResult(NamedTuple):
    state: EnvState
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    info: StepInfo


def step(
    config: NanogridConfig,
    params: NanogridParams,
    state: EnvState,
    action: jnp.ndarray,
) -> StepResult:
    """One environment step (reference call stack: SURVEY.md §3.3)."""
    dtype = params.dtype
    N = config.num_chargers
    L = config.table_len
    T = config.steps_per_day
    dt = config.time_interval
    t = state.t
    sched = state.schedule

    action = jnp.asarray(action, dtype)
    charger_actions = action[:N]
    if config.battery_system:
        battery_action = action[-1]
    else:
        battery_action = jnp.asarray(0.0, dtype)

    # t == 0: BESS day-start bookkeeping (central_management_system.py:93-94).
    if config.battery_system:
        batt_init_soc = jnp.where(t == 0, state.batt_soc, state.batt_init_soc)
    else:
        batt_init_soc = state.batt_init_soc

    # --- charging station (charging_station.py:281-300, charger.py:37-144) ---
    tm1 = (t - 1) % L  # Python negative-index wraparound at t=0 (SURVEY.md Q2)
    occupied = _col(sched.occupancy, t) > 0
    is_arrival = _col(sched.is_arrival, t) > 0
    cap_eff = jnp.where(is_arrival, _col(sched.capacity, t), _col(sched.capacity, tm1))
    soc_col_t = _col(state.soc, t)
    soc_eff = jnp.where(is_arrival, soc_col_t, _col(state.soc, tm1))

    ch = physics.charger_step(
        charger_actions,
        occupied,
        soc_eff,
        cap_eff,
        params.charger_mask,
        params.charger_max_power,
        params.charger_efficiency,
        params.nonexistent_marker,
        dt,
    )
    new_soc_col = jnp.where(occupied & (params.charger_mask > 0), ch.soc_new, soc_col_t)
    soc_hist = jax.lax.dynamic_update_index_in_dim(state.soc, new_soc_col, t, axis=1)

    total_charging = jnp.sum(jnp.where(ch.power > 0, ch.power, 0.0))
    total_discharging = jnp.sum(jnp.where(ch.power < 0, ch.power, 0.0))

    # --- vehicle penalties (penaliser.py:31-87) ---
    # The check-set comes from the previous step's trailing observe, carried in
    # state.pmask ([verified at runtime]; across day rollovers this correctly
    # carries the previous day's T-1 mask, matching reference continuation).
    soc_pen = _col(soc_hist, tm1)
    req_pen = _col(sched.requested_soc, tm1)
    vehicle_penalty = physics.vehicle_insufficiency_penalty(
        state.pmask, soc_pen, req_pen, params.soc_margin_ratio, params.penalty_gain
    )
    # trailing observe at the (still old) timestep recomputes the set for the
    # next step (charging_station.py:34-40 inside observe)
    pmask_next = _col(_penalty_mask_table(config, sched), t)
    nonexistent_penalty = jnp.sum(ch.nonexistent)

    # --- PV (pv_system_manager.py:87-91, central_management_system.py:99-103) ---
    if config.pv_system:
        solar_power = params.solar_power[t] * state.pv_shift
    else:
        solar_power = jnp.asarray(0.0, dtype)

    # --- energy balance & grid (central_management_system.py:105-106,157-185) ---
    total_power = total_charging + total_discharging
    remaining = total_power - solar_power

    if config.battery_system:
        b = physics.battery_step(
            battery_action,
            remaining,
            state.batt_soc,
            params.batt_capacity,
            params.batt_max_power,
            params.batt_efficiency,
            dt,
        )
        grid_power = b.remaining_demand
        batt_soc = b.soc_new
        dod_penalty = physics.battery_dod_penalty(batt_soc, params.batt_dod, params.penalty_gain)
        batt_power_used = b.power_used
        batt_power_calc = b.power_calculated
    else:
        grid_power = remaining
        batt_soc = state.batt_soc
        dod_penalty = jnp.asarray(0.0, dtype)
        batt_power_used = jnp.asarray(0.0, dtype)
        batt_power_calc = jnp.asarray(0.0, dtype)

    grid_energy = grid_power * dt
    price_t = params.price[t]
    g_cost = physics.grid_energy_cost(grid_energy, price_t, params.sell_coefficient)

    # --- totals (penaliser.py:177-187, accountant.py:34-36) ---
    total_battery_penalty = dod_penalty
    total_vehicle_penalty = vehicle_penalty
    total_penalty = (
        params.w_battery_penalty * total_battery_penalty
        + params.w_vehicle_penalty * total_vehicle_penalty
    )
    total_cost = params.grid_cost_weight * jnp.abs(g_cost) + total_penalty
    reward = -total_cost

    # --- observation at the *old* t (env.py:173-174), then advance ---
    post_state = state._replace(soc=soc_hist, batt_soc=batt_soc, batt_init_soc=batt_init_soc)
    obs = observe(config, params, post_state)

    t_next = t + 1
    done = t_next == T
    key, k_shift = jax.random.split(state.key)
    new_shift = jax.random.randint(k_shift, (), 0, 181).astype(dtype) / 100.0

    next_state = post_state._replace(
        t=jnp.where(done, 0, t_next),
        pv_shift=jnp.where(done, new_shift, state.pv_shift),
        pmask=pmask_next,
        key=key,
        day=state.day + done.astype(jnp.int32),
    )

    info = StepInfo(
        total_cost=total_cost,
        grid_energy_cost=g_cost,
        grid_energy=grid_energy,
        grid_power=grid_power,
        utilized_solar_energy=solar_power,
        total_penalty=total_penalty,
        total_battery_penalty=total_battery_penalty,
        battery_soc_below_dod_penalty=dod_penalty,
        # The BESS computes over(-dis)charging flag values, but the penaliser
        # setters that would surface them are never called in the reference
        # (penaliser.py:98-102 have no call sites), so these series stay 0.0.
        battery_overcharging_penalty=jnp.asarray(0.0, dtype),
        battery_over_discharging_penalty=jnp.asarray(0.0, dtype),
        low_resource_utilisation_penalty=jnp.asarray(0.0, dtype),  # dead code in reference (penaliser.py:113-129)
        total_vehicle_penalty=total_vehicle_penalty,
        insufficiently_charged_vehicles_penalty=total_vehicle_penalty,
        needlessly_charged_vehicles_penalty=jnp.asarray(0.0, dtype),  # never summed (penaliser.py:53-56)
        # The reference computes per-charger over(-dis)charging markers but the
        # summing calls are commented out (penaliser.py:34-35), so these totals
        # stay 0.0 forever.
        overcharged_vehicles_penalty=jnp.asarray(0.0, dtype),
        over_discharged_vehicles_penalty=jnp.asarray(0.0, dtype),
        battery_action=battery_action,
        charger_actions=charger_actions,
        total_charging_power=total_charging,
        total_discharging_power=total_discharging,
        charger_power_values=ch.power,
        battery_power_value=batt_power_used,
        battery_calculated_power_value=batt_power_calc,
        battery_state_of_charge=batt_soc,
        initial_battery_state_of_charge=batt_init_soc,
        discharging_nonexistent_vehicles_penalty=nonexistent_penalty,
    )
    return StepResult(next_state, obs, reward, done, info)
