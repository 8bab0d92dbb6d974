"""Schedule-generator tests: structural invariants + distributional match vs the
reference generator (utils/charging_station.py:193-279)."""

import numpy as np
import jax
import jax.numpy as jnp

import oracle
from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.core.generate import (
    generate_schedule,
    schedule_from_arrays,
    schedule_to_json_dict,
)


CFG = NanogridConfig(
    num_chargers=4, pv_system=False, battery_system=False, penalty_mode="sparse"
)


def _gen(seed=0, config=CFG):
    params = make_params(config, dtype=jnp.float64)
    return generate_schedule(jax.random.PRNGKey(seed), config, params)


def test_structural_invariants():
    for seed in range(20):
        s = _gen(seed)
        occ = np.asarray(s.occupancy)
        is_arr = np.asarray(s.is_arrival)
        cap = np.asarray(s.capacity)
        req = np.asarray(s.requested_soc)
        soc0 = np.asarray(s.soc_init)
        dep = np.asarray(s.dep_obs)
        T = CFG.steps_per_day

        # last column is the always-zero padding column (reference zeros(25))
        assert not occ[:, T].any() and not soc0[:, T].any()
        # arrivals imply occupancy, an arrival SoC in (0.1, 0.9), a capacity in [15, 119]
        arr_mask = is_arr[:, :T] > 0
        assert (occ[:, :T][arr_mask] == 1).all()
        assert ((soc0[:, :T][arr_mask] > 0.1) & (soc0[:, :T][arr_mask] < 0.9)).all()
        assert ((cap[:, :T][arr_mask] >= 15) & (cap[:, :T][arr_mask] <= 119)).all()
        # requested SoC is 1.0 while occupied when the toggle is off
        occ_mask = occ[:, :T] > 0
        assert (req[:, :T][occ_mask] == 1.0).all()
        # departure countdown: positive while occupied, decreases by 1 per step
        # within a stay
        assert (dep[:, :T][occ_mask] >= 1).all()
        # occupancy runs are at least 4 steps (departure >= arrival + 4/dt) and
        # departure gaps exist between consecutive vehicles
        for c in range(CFG.num_chargers):
            arr_ts = np.where(arr_mask[c])[0]
            for t0 in arr_ts:
                d = int(dep[c, t0])
                assert d >= 4, f"dep-arr gap {d} < 4"
                run_end = min(t0 + d, T)
                assert occ[c, t0:run_end].all()
                if run_end < T:
                    # at the departure step the charger is free again
                    if t0 + d < T:
                        assert occ[c, t0 + d] == 0


def test_departure_bounds_q6():
    """Departures can exceed the day (up to T+10/dt-1 via the low>=high branch,
    SURVEY.md Q6) but never exceed t+10."""
    max_dep_minus_t = 0
    for seed in range(50):
        s = _gen(seed)
        dep = np.asarray(s.dep_obs)
        is_arr = np.asarray(s.is_arrival) > 0
        T = CFG.steps_per_day
        for c in range(CFG.num_chargers):
            for t in range(T):
                if is_arr[c, t]:
                    d_abs = t + dep[c, t]
                    assert t + 4 <= d_abs <= t + 10
                    assert d_abs <= T + 3  # t<=T-1, low=t+4<=T+3
                    max_dep_minus_t = max(max_dep_minus_t, d_abs - T)
    assert max_dep_minus_t > 0, "never saw an over-day departure in 50 seeds"


def test_distribution_matches_reference():
    """Occupancy rate, arrival count, SoC/capacity moments vs the reference
    generator over many seeded days."""
    ref_occ, ref_socs, ref_caps, ref_count = [], [], [], []
    for seed in range(60):
        np.random.seed(seed)
        env = oracle.make_reference_env(
            price_model=0, number_of_chargers=4,
            pv_system_available_in_model=False, battery_system_available_in_model=False,
            vehicle_to_everything=False, enable_different_vehicle_battery_capacities=True,
            enable_requested_state_of_charge=False, time_interval="1h",
            charging_mode="bounded", vehicle_uncharged_penalty_mode="sparse",
        )
        env.reset()
        sa = oracle.reference_schedule_as_dict(env)
        occ = sa["Charger_occupancy"][:, :24]
        ref_occ.append(occ.mean())
        ref_count.append(sum(len(a) for a in sa["Arrivals"]))
        soc = sa["SOC"][:, :24]
        ref_socs.extend(soc[soc > 0].tolist())
        cap = sa["Vehicle_capacities"][:, :24]
        ref_caps.extend(np.unique(cap[cap > 0]).tolist())

    eng_occ, eng_socs, eng_caps, eng_count = [], [], [], []
    for seed in range(60):
        s = _gen(seed + 1000)
        occ = np.asarray(s.occupancy)[:, :24]
        eng_occ.append(occ.mean())
        is_arr = np.asarray(s.is_arrival)[:, :24]
        eng_count.append(is_arr.sum())
        soc0 = np.asarray(s.soc_init)[:, :24]
        eng_socs.extend(soc0[soc0 > 0].tolist())
        cap = np.asarray(s.capacity)[:, :24]
        eng_caps.extend(np.unique(cap[cap > 0]).tolist())

    # Tolerances sized at ~3 standard errors for these sample sizes.
    assert abs(np.mean(ref_occ) - np.mean(eng_occ)) < 0.05
    assert abs(np.mean(ref_count) - np.mean(eng_count)) < 1.2
    assert abs(np.mean(ref_socs) - np.mean(eng_socs)) < 0.06
    assert abs(np.std(ref_socs) - np.std(eng_socs)) < 0.04
    assert abs(np.mean(ref_caps) - np.mean(eng_caps)) < 8.0


def test_json_round_trip():
    """generate -> json dict -> schedule_from_arrays reproduces the tables."""
    s = _gen(7)
    payload = schedule_to_json_dict(s, CFG)
    s2 = schedule_from_arrays(
        CFG,
        soc=np.asarray(payload["SOC"]),
        arrivals=payload["Arrivals"],
        departures=payload["Departures"],
        occupancy=np.asarray(payload["Charger_occupancy"]),
        capacities=np.asarray(payload["Vehicle_capacities"]),
        requested_soc=np.asarray(payload["Requested_SOC"]),
    )
    for name in ("occupancy", "capacity", "requested_soc", "soc_init", "is_arrival", "dep_obs",
                 "mask_departing", "mask_departing3"):
        np.testing.assert_allclose(
            np.asarray(getattr(s2, name)), np.asarray(getattr(s, name)),
            err_msg=f"round-trip mismatch in {name}",
        )


def test_charger_mask_heterogeneous():
    """Masked-out chargers must stay empty (heterogeneous batch support)."""
    config = NanogridConfig(num_chargers=8, pv_system=False, battery_system=False)
    params = make_params(config, dtype=jnp.float64)
    params = params._replace(charger_mask=jnp.asarray([1, 1, 1, 0, 0, 0, 0, 0], jnp.float64))
    s = generate_schedule(jax.random.PRNGKey(0), config, params)
    occ = np.asarray(s.occupancy)
    assert occ[3:].sum() == 0
    assert occ[:3].sum() > 0


def test_requested_soc_generation():
    config = NanogridConfig(
        num_chargers=4, pv_system=False, battery_system=False,
        requested_state_of_charge=True,
    )
    params = make_params(config, dtype=jnp.float64)
    s = generate_schedule(jax.random.PRNGKey(3), config, params)
    req = np.asarray(s.requested_soc)
    soc0 = np.asarray(s.soc_init)
    is_arr = np.asarray(s.is_arrival) > 0
    # requested SoC in (arrival_soc + 0.1, 1.0] at arrival steps
    assert ((req[is_arr] >= soc0[is_arr] + 0.1) & (req[is_arr] <= 1.0)).all()
