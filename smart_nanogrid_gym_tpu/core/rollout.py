"""Fused full-day rollout — the hot path.

:mod:`.step` is the general transition (per-env timestep, arbitrary ``t``) used
by the gym adapter and single-step APIs.  For throughput, this module exploits
the structure the reference can't: **all envs advance in lockstep and a day has
a fixed length**, so the timestep is the scan index, not per-env state.  That
turns every per-step table lookup into a zero-cost ``lax.scan`` xs slice:

- schedule tables are transposed once to time-major ``(T, B, N)`` and fed as
  scan xs (contiguous leading-dim slices — no per-step gathers),
- the lookahead windows of the price/radiation observations are precomputed as
  ``(T, B, k)`` tables (static slices, hoisted out of the loop),
- the SoC "history" needs no carried (B, N, L) array: within one day, column t
  is written exactly once at step t (reference charger.py:86,136), so the scan
  carries only the previously-written column; the full history is reassembled
  once at day end.

The body is pure element-wise work on (B, N) blocks; XLA fuses it into a
handful of kernels.  Exactness vs the sequential :func:`..core.transition.step` path
is asserted in tests/test_rollout_fused.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import physics
from .config import NanogridConfig
from .params import NanogridParams
from .state import EnvState, StepInfo
from .transition import _penalty_mask_table


class DayTables(NamedTuple):
    """Time-major per-step inputs for the fused scan (leaves: (T, B, ...))."""

    occupancy: jnp.ndarray       # (T, B, N)
    capacity_eff: jnp.ndarray    # (T, B, N) capacity read at t (arrival) or t-1
    requested_prev: jnp.ndarray  # (T, B, N) requested SoC at (t-1) mod L
    soc_cols: jnp.ndarray        # (T, B, N) *current history* SoC column t — on a
    #                              fresh day these equal the generation values; on
    #                              a continued day (no reset, Q8) they hold the
    #                              previous day's written values, as the reference
    #                              reads them (charger.py:42-45,62-67)
    is_arrival: jnp.ndarray      # (T, B, N)
    dep_obs: jnp.ndarray         # (T, B, N)
    penalty_mask: jnp.ndarray    # (T, B, N) mask at the *current* index t (the
    #                              trailing-observe update; consumption is lagged
    #                              via the scan carry seeded from state.pmask)
    price: jnp.ndarray           # (T, B)
    price_norm: jnp.ndarray      # (T, B)
    price_pred: jnp.ndarray      # (T, B, k)
    rad_norm: jnp.ndarray        # (T, B)
    rad_pred: jnp.ndarray        # (T, B, k)
    solar_power: jnp.ndarray     # (T, B)


def build_day_tables(config: NanogridConfig, params: NanogridParams, state: EnvState) -> DayTables:
    """Precompute all time-major per-step inputs (batched: leaves (B, ...))."""
    T = config.steps_per_day
    L = config.table_len
    k = config.lookahead
    sched = state.schedule

    def tm(table):  # (B, N, L) -> (T, B, N), columns 0..T-1
        return jnp.moveaxis(table[..., :T], -1, 0)

    # capacity at t if arrival else t-1 (charger.py:62-67); roll brings col t-1
    # to position t, with col (t-1)%L = L-1 for t=0 (the always-zero pad column).
    cap = sched.capacity
    cap_prev = jnp.roll(cap, 1, axis=-1)
    cap_eff = jnp.where(sched.is_arrival > 0, cap, cap_prev)

    req_prev = jnp.roll(sched.requested_soc, 1, axis=-1)

    # penalty mask table at the current index; the one-step-lagged consumption
    # comes from carrying state.pmask through the scan
    pmask = _penalty_mask_table(config, sched)[..., :T]

    # lookahead windows (static slices, stacked once)
    def windows(vec):  # (B, P) -> (T, B, k)
        return jnp.stack([vec[..., t + 1 : t + 1 + k] for t in range(T)], axis=0)

    price_t = jnp.moveaxis(params.price[..., :T], -1, 0)
    price_norm_t = jnp.moveaxis(params.price_norm[..., :T], -1, 0)
    rad_norm_t = jnp.moveaxis(params.rad_norm[..., :T], -1, 0)
    solar_t = jnp.moveaxis(params.solar_power[..., :T], -1, 0)

    return DayTables(
        occupancy=tm(sched.occupancy),
        capacity_eff=tm(cap_eff),
        requested_prev=tm(req_prev),
        soc_cols=tm(state.soc),
        is_arrival=tm(sched.is_arrival),
        dep_obs=tm(sched.dep_obs),
        penalty_mask=jnp.moveaxis(pmask, -1, 0),
        price=price_t,
        price_norm=price_norm_t,
        price_pred=windows(params.price_norm),
        rad_norm=rad_norm_t,
        rad_pred=windows(params.rad_norm),
        solar_power=solar_t,
    )


def _assemble_obs(config, xs, soc_col, dep_col, batt_soc, pv_shift):
    parts = []
    if config.pv_system:
        parts += [
            (xs.rad_norm * pv_shift)[..., None],
            xs.price_norm[..., None],
            xs.rad_pred * pv_shift[..., None],
            xs.price_pred,
        ]
    else:
        parts += [xs.price_norm[..., None], xs.price_pred]
    parts += [soc_col, dep_col / 24.0]
    if config.battery_system:
        parts += [batt_soc[..., None]]
    obs = jnp.concatenate(parts, axis=-1)
    if config.cast_obs_to_f32:
        obs = obs.astype(jnp.float32)
    return obs


def fused_day_rollout(
    config: NanogridConfig,
    params: NanogridParams,
    state: EnvState,
    policy_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    key: jnp.ndarray,
    collect_info: bool = False,
    policy_aux: bool = False,
    obs0: jnp.ndarray | None = None,
    policy_xs=None,
):
    """Roll exactly one day over a batched state (leaves (B, ...)); state.t must
    be 0 (day start).  Returns ``(next_state, (obs, reward, done[, info][, aux]))``
    with trajectories stacked time-major.

    With ``policy_aux=True`` the policy returns ``(actions, aux)`` and the
    stacked aux pytree is appended to the trajectory — this is how the PPO
    learner collects log-probs/values without a second forward pass.

    ``policy_xs`` is an optional pytree of per-step policy inputs (leaves
    ``(T, ...)``) sliced into the scan and passed as a third policy argument
    ``policy_fn(obs, key_t, xs_t)`` — how the DDPG learner feeds its
    precomputed Ornstein-Uhlenbeck noise sequence (the OU recurrence is
    trajectory-independent, so it runs once outside the day scan).

    Produces results identical to 24 sequential :func:`..core.transition.step` calls
    (asserted in tests), including the day-end PV-shift redraw and battery
    carry-over (SURVEY.md Q8).
    """
    T = config.steps_per_day
    dt = config.time_interval
    dtype = params.dtype
    N = config.num_chargers
    B = state.pv_shift.shape[0] if state.pv_shift.ndim else None
    assert B is not None, "fused_day_rollout expects a batched state"

    tables = build_day_tables(config, params, state)
    step_keys = jax.random.split(key, T)

    # initial previously-written column: (t-1)%L at t=0 is the pad column L-1
    prev_col = state.soc[..., config.table_len - 1]
    batt_init = state.batt_soc  # set at t==0 (central_management_system.py:93-94)
    if obs0 is None:
        # fresh day from reset(): the reset observation; for continuation runs
        # (Q8 rollover) callers must pass the previous day's trailing obs
        obs0 = _obs_from_state(config, params, state, tables)

    def body(carry, xs_and_key):
        prev_col, batt_soc, pmask, obs = carry
        if policy_xs is None:
            xs, key_t, t_idx = xs_and_key
            policy_args = (obs, key_t)
        else:
            xs, key_t, t_idx, p_xs = xs_and_key
            policy_args = (obs, key_t, p_xs)

        if policy_aux:
            actions, aux = policy_fn(*policy_args)
            actions = actions.astype(dtype)
        else:
            actions = policy_fn(*policy_args).astype(dtype)
            aux = None
        charger_actions = actions[..., :N]
        battery_action = actions[..., -1] if config.battery_system else jnp.zeros(actions.shape[:-1], dtype)

        occupied = xs.occupancy > 0
        soc_eff = jnp.where(xs.is_arrival > 0, xs.soc_cols, prev_col)

        ch = physics.charger_step(
            charger_actions,
            occupied,
            soc_eff,
            xs.capacity_eff,
            params.charger_mask[..., None, :] if params.charger_mask.ndim == 1 else params.charger_mask,
            _bcol(params.charger_max_power),
            _bcol(params.charger_efficiency),
            _bcol(params.nonexistent_marker),
            dt,
        )
        new_col = jnp.where(occupied & (params.charger_mask > 0), ch.soc_new, xs.soc_cols)

        total_charging = jnp.sum(jnp.where(ch.power > 0, ch.power, 0.0), axis=-1)
        total_discharging = jnp.sum(jnp.where(ch.power < 0, ch.power, 0.0), axis=-1)

        vehicle_penalty = physics.vehicle_insufficiency_penalty(
            pmask, prev_col, xs.requested_prev,
            _bcol(params.soc_margin_ratio), _bcol(params.penalty_gain),
        )
        nonexistent_penalty = jnp.sum(ch.nonexistent, axis=-1)

        solar_power = xs.solar_power * state_pv_shift if config.pv_system else jnp.zeros_like(total_charging)

        total_power = total_charging + total_discharging
        remaining = total_power - solar_power

        if config.battery_system:
            b = physics.battery_step(
                battery_action, remaining, batt_soc,
                params.batt_capacity, params.batt_max_power, params.batt_efficiency, dt,
            )
            grid_power = b.remaining_demand
            batt_soc = b.soc_new
            dod_penalty = physics.battery_dod_penalty(batt_soc, params.batt_dod, params.penalty_gain)
            batt_power_used, batt_power_calc = b.power_used, b.power_calculated
        else:
            grid_power = remaining
            dod_penalty = jnp.zeros_like(total_charging)
            batt_power_used = jnp.zeros_like(total_charging)
            batt_power_calc = jnp.zeros_like(total_charging)

        grid_energy = grid_power * dt
        g_cost = physics.grid_energy_cost(grid_energy, xs.price, params.sell_coefficient)

        total_penalty = params.w_battery_penalty * dod_penalty + params.w_vehicle_penalty * vehicle_penalty
        total_cost = params.grid_cost_weight * jnp.abs(g_cost) + total_penalty
        reward = -total_cost

        obs_next = _assemble_obs(config, xs, new_col, xs.dep_obs, batt_soc, state_pv_shift)
        done = jnp.broadcast_to(t_idx == T - 1, reward.shape)

        if collect_info:
            zero = jnp.zeros_like(total_cost)
            info = StepInfo(
                total_cost=total_cost, grid_energy_cost=g_cost, grid_energy=grid_energy,
                grid_power=grid_power, utilized_solar_energy=solar_power,
                total_penalty=total_penalty, total_battery_penalty=dod_penalty,
                battery_soc_below_dod_penalty=dod_penalty,
                battery_overcharging_penalty=zero, battery_over_discharging_penalty=zero,
                low_resource_utilisation_penalty=zero,
                total_vehicle_penalty=vehicle_penalty,
                insufficiently_charged_vehicles_penalty=vehicle_penalty,
                needlessly_charged_vehicles_penalty=zero,
                overcharged_vehicles_penalty=zero, over_discharged_vehicles_penalty=zero,
                battery_action=battery_action, charger_actions=charger_actions,
                total_charging_power=total_charging, total_discharging_power=total_discharging,
                charger_power_values=ch.power, battery_power_value=batt_power_used,
                battery_calculated_power_value=batt_power_calc,
                battery_state_of_charge=batt_soc,
                initial_battery_state_of_charge=batt_init,
                discharging_nonexistent_vehicles_penalty=nonexistent_penalty,
            )
            out = (obs_next, reward, done, info, new_col)
        else:
            out = (obs_next, reward, done, new_col)
        if policy_aux:
            out = out + (aux,)
        # trailing observe recomputes the penalty set at the (old) current t
        return (new_col, batt_soc, xs.penalty_mask, obs_next), out

    state_pv_shift = state.pv_shift
    t_indices = jnp.arange(T)
    carry0 = (prev_col, state.batt_soc, state.pmask, obs0)
    scan_xs = (tables, step_keys, t_indices)
    if policy_xs is not None:
        scan_xs = scan_xs + (policy_xs,)
    carry, outs = jax.lax.scan(body, carry0, scan_xs)
    last_col, batt_soc_final, pmask_final, obs_final = carry

    aux_traj = None
    if collect_info and policy_aux:
        obs_traj, rewards, dones, infos, cols, aux_traj = outs
    elif collect_info:
        obs_traj, rewards, dones, infos, cols = outs
    elif policy_aux:
        obs_traj, rewards, dones, cols, aux_traj = outs
        infos = None
    else:
        obs_traj, rewards, dones, cols = outs
        infos = None

    # reassemble the SoC history: columns 0..T-1 were each written once
    soc_hist = jnp.concatenate(
        [jnp.moveaxis(cols, 0, -1), state.soc[..., T:]], axis=-1
    )

    # day end: t -> 0, redraw PV shift, keep schedule/battery (SURVEY.md Q8).
    # The key advances exactly as T sequential step() calls would (one split
    # per step), so chained fused days bit-match sequential stepping.
    def redraw(k):
        def split_once(k, _):
            k2, sub = jax.random.split(k)
            return k2, sub

        k_final, subs = jax.lax.scan(split_once, k, None, length=T)
        shift = jax.random.randint(subs[-1], (), 0, 181).astype(dtype) / 100.0
        return k_final, shift

    new_keys, new_shifts = jax.vmap(redraw)(state.key)
    next_state = state._replace(
        soc=soc_hist,
        batt_soc=batt_soc_final,
        batt_init_soc=batt_init,
        pv_shift=new_shifts,
        pmask=pmask_final,
        key=new_keys,
        day=state.day + 1,
    )
    traj = (obs_traj, rewards, dones)
    if collect_info:
        traj = traj + (infos,)
    if policy_aux:
        traj = traj + (aux_traj,)
    return next_state, traj


def _bcol(x):
    """Broadcast a per-env scalar param to charger columns: (B,) -> (B, 1)."""
    return x[..., None] if getattr(x, "ndim", 0) == 1 else x


def _obs_from_state(config, params, state, tables):
    """Reset-time observation (t=0) from the time-major tables."""
    xs0 = jax.tree.map(lambda x: x[0], tables)
    soc_col0 = state.soc[..., 0]
    batt = state.batt_soc
    return _assemble_obs(config, xs0, soc_col0, xs0.dep_obs, batt, state.pv_shift)
