"""Pure, branch-free per-step physics.

Each function re-expresses one reference component as vectorised jnp math with
``where``-selects instead of Python branches, so the whole step fuses into a
single XLA program (no data-dependent control flow — everything here is
element-wise work in one pass over the (batch, chargers) axes under vmap).

Sign/flag conventions are replicated from the reference *exactly*, including
its quirks:

- charger discharge: the over-discharge flag is computed as
  ``ceil(0.5*(1+sign(calc)))`` (utils/charger.py:122) which is 1 for any
  calc ≥ 0, i.e. the flag fires on every *normal* discharge and the reported
  power is replaced by the full-drain value ``-(soc·cap/Δt)`` (charger.py:128-132)
  — inverted relative to the BESS flag (battery_energy_storage_system.py:82).
  Replicated bit-for-bit (trajectory exactness beats plausibility).
- BESS charge never clamps power when overcharging — excess energy "turns to
  heat" but still offsets grid demand (battery_energy_storage_system.py:46-72).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ChargerStepResult(NamedTuple):
    power: jnp.ndarray              # (N,) per-charger power [kW] (negative = discharge)
    soc_new: jnp.ndarray            # (N,) new SoC for occupied chargers
    overcharging: jnp.ndarray       # (N,) overcharge marker (flag · max_power)
    over_discharging: jnp.ndarray   # (N,) over-discharge marker (flag · max_power)
    nonexistent: jnp.ndarray        # (N,) 100-marker for acting on empty chargers


def charger_step(
    actions: jnp.ndarray,       # (N,)
    occupied: jnp.ndarray,      # (N,) bool
    soc_eff: jnp.ndarray,       # (N,) SoC read at t (arrival) or t-1 (charger.py:42-45,62-67)
    cap_eff: jnp.ndarray,       # (N,) capacity read likewise
    charger_mask: jnp.ndarray,  # (N,) active-charger mask (heterogeneous batches)
    max_power: jnp.ndarray,
    efficiency: jnp.ndarray,
    nonexistent_marker: jnp.ndarray,
    time_interval: float,
) -> ChargerStepResult:
    """Vectorised Charger.charge_or_discharge_vehicle (utils/charger.py:37-144)."""
    dt = time_interval
    safe_cap = jnp.where(cap_eff > 0, cap_eff, 1.0)

    # Shared power formula: action · 22 · 0.95 (charger.py:92-94,142-144).
    p_raw = actions * max_power * efficiency
    calc = soc_eff + (p_raw * dt) / safe_cap

    # charge (action > 0): overcharge flag floor(0.5*(1+sign(calc-1))) (charger.py:73)
    oc_flag = jnp.floor(0.5 * (1.0 + jnp.sign(calc - 1.0)))
    soc_charged = jnp.minimum(calc, 1.0)

    # discharge (action < 0): flag ceil(0.5*(1+sign(calc))) (charger.py:122);
    # when the flag fires, power is replaced by the full drain (charger.py:128-132).
    od_flag = jnp.ceil(0.5 * (1.0 + jnp.sign(calc)))
    p_discharge = jnp.where(od_flag > 0, -(soc_eff * cap_eff) / dt, p_raw)
    soc_discharged = jnp.maximum(0.0, calc)

    is_pos = actions > 0
    is_neg = actions < 0

    power = jnp.where(is_pos, p_raw, jnp.where(is_neg, p_discharge, 0.0))
    soc_new = jnp.where(is_pos, soc_charged, jnp.where(is_neg, soc_discharged, soc_eff))
    overcharging = jnp.where(is_pos, oc_flag * max_power, 0.0)
    over_discharging = jnp.where(is_neg, od_flag * max_power, 0.0)

    active = occupied & (charger_mask > 0)
    power = jnp.where(active, power, 0.0)
    overcharging = jnp.where(active, overcharging, 0.0)
    over_discharging = jnp.where(active, over_discharging, 0.0)
    # Acting on an empty (but real) charger sets the 100-marker (charger.py:146-156).
    nonexistent = jnp.where(
        (~occupied) & (charger_mask > 0) & (actions != 0), nonexistent_marker, 0.0
    )
    return ChargerStepResult(power, soc_new, overcharging, over_discharging, nonexistent)


class BatteryStepResult(NamedTuple):
    soc_new: jnp.ndarray
    power_used: jnp.ndarray        # current_power_value (bess.py:19)
    power_calculated: jnp.ndarray  # calculated_power_value (bess.py:20)
    overcharging: jnp.ndarray
    over_discharging: jnp.ndarray
    remaining_demand: jnp.ndarray  # demand after battery dispatch (grid power)


def battery_step(
    action: jnp.ndarray,
    demand: jnp.ndarray,
    soc: jnp.ndarray,
    capacity: jnp.ndarray,
    max_power: jnp.ndarray,
    efficiency: jnp.ndarray,
    time_interval: float,
) -> BatteryStepResult:
    """Vectorised BatteryEnergyStorageSystem.charge_or_discharge
    (utils/battery_energy_storage_system.py:30-106)."""
    dt = time_interval
    p_calc = action * max_power * efficiency
    calc = soc + (p_calc * dt) / capacity

    # charge (action > 0): soc = min(calc, 1); demand += P (bess.py:46-72 via the
    # sign flip at :37-38 — returns -(available - P) = demand + P).
    oc_flag = jnp.floor(0.5 * (1.0 + jnp.sign(calc - 1.0)))
    soc_charged = jnp.minimum(calc, 1.0)

    # discharge (action < 0): flag 1-ceil(0.5*(1+sign(calc))) (bess.py:82);
    # over-discharge clamps power to the available SoC (bess.py:86-94).
    od_flag = 1.0 - jnp.ceil(0.5 * (1.0 + jnp.sign(calc)))
    p_discharge = jnp.where(od_flag > 0, -(soc * capacity) / dt, p_calc)
    soc_discharged = jnp.maximum(0.0, calc)

    is_pos = action > 0
    is_neg = action < 0
    is_zero = action == 0

    soc_new = jnp.where(is_pos, soc_charged, jnp.where(is_neg, soc_discharged, soc))
    power_used = jnp.where(is_pos, p_calc, jnp.where(is_neg, p_discharge, 0.0))
    power_calculated = jnp.where(is_zero, 0.0, p_calc)
    overcharging = jnp.where(is_pos, oc_flag * max_power, 0.0)
    over_discharging = jnp.where(is_neg, od_flag * max_power, 0.0)
    remaining = demand + jnp.where(is_zero, 0.0, power_used)
    return BatteryStepResult(soc_new, power_used, power_calculated, overcharging, over_discharging, remaining)


def vehicle_insufficiency_penalty(
    mask: jnp.ndarray,       # (N,) penalty-check mask (already includes occupancy)
    soc: jnp.ndarray,        # (N,) SoC read at (t-1) mod L — SURVEY.md Q2 wraparound
    requested: jnp.ndarray,  # (N,) requested SoC read likewise
    margin_ratio: jnp.ndarray,
    gain: jnp.ndarray,
) -> jnp.ndarray:
    """Vectorised Penaliser.penalise_state_of_charge_outside_margin
    (utils/penaliser.py:71-87): insufficiency penalty ((req - soc)·10)² outside a
    5 % margin; the needless-charging branch is computed but excluded from every
    total by the reference (penaliser.py:53-56,186-187)."""
    lower = margin_ratio * requested
    insufficient = soc < requested - lower
    pen = ((requested - soc) * gain) ** 2
    return jnp.sum(mask * jnp.where(insufficient, pen, 0.0), axis=-1)


def battery_dod_penalty(soc: jnp.ndarray, dod: jnp.ndarray, gain: jnp.ndarray) -> jnp.ndarray:
    """Penaliser.penalise_battery_state_below_depth_of_discharge
    (utils/penaliser.py:104-111) — the only battery penalty in the total
    (penaliser.py:183-184), under the Q1-fixed semantics (SURVEY.md Q1)."""
    return jnp.where(soc < dod, ((dod - soc) * gain) ** 2, 0.0)


def grid_energy_cost(
    energy: jnp.ndarray, price: jnp.ndarray, sell_coefficient: jnp.ndarray
) -> jnp.ndarray:
    """Accountant.calculate_grid_energy_cost (utils/accountant.py:26-32):
    selling to the grid is priced at 0.8×."""
    return jnp.where(energy < 0, energy * sell_coefficient * price, energy * price)
