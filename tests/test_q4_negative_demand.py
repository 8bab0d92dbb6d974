"""SURVEY.md Q4 — negative total demand (aggressive v2x discharge).

The reference traps this region instead of handling it
(central_management_system.py:158-165):

- **no v2x**: ``calculate_grid_power`` raises ``ValueError`` when
  ``power_demand < 0`` — unreachable through the declared action space
  (charger actions are >= 0 without v2x, so demand is a sum of non-negatives);
- **v2x**: a live ``breakpoint()`` fires, then execution FALLS THROUGH to the
  ordinary energy-balance math (``remaining = demand - solar``; sell branch of
  the accountant) — the trap is a debugger hook, not control flow.

Build stance (SURVEY.md Q4: "treat as env invariant; never block"): the engine
computes straight through negative demand with the exact same math the
reference runs after its breakpoint — pinned here by (a) the reference's own
two trap branches, (b) step-exact equality between the engine and the live
reference (breakpoint disabled, as the oracle always runs) on episodes that
actually drive demand negative, and (c) the removal of the fuzzer's old −0.08
discharge floor (tests/test_exactness_fuzz.py now samples the full [-1, 1]
v2x action range).
"""

import sys

import numpy as np
import pytest

import oracle
from test_exactness import assert_trajectories_match, run_pair


V2X_KW = dict(
    price_model=0, number_of_chargers=4,
    pv_system_available_in_model=False,
    battery_system_available_in_model=False,
    vehicle_to_everything=True,
    enable_different_vehicle_battery_capacities=True,
    enable_requested_state_of_charge=False,
    time_interval="1h", charging_mode="bounded",
    vehicle_uncharged_penalty_mode="sparse",
)


def test_reference_no_v2x_negative_demand_raises():
    """Reference trap branch 1 (central_management_system.py:158-159)."""
    kw = dict(V2X_KW, vehicle_to_everything=False)
    env = oracle.make_reference_env(**kw)
    with pytest.raises(ValueError, match="V2X"):
        env.central_management_system.calculate_grid_power(-5.0, 0.0, 0.0)


def test_reference_v2x_negative_demand_breakpoints_then_computes_through():
    """Reference trap branch 2 (central_management_system.py:160-165): the
    breakpoint is a debugger hook only — after it, the ordinary balance math
    runs.  Replace sys.breakpointhook (bypasses PYTHONBREAKPOINT=0) to prove
    the trap fires exactly once AND the fall-through result is demand − solar."""
    env = oracle.make_reference_env(**V2X_KW)
    calls = []
    old_hook = sys.breakpointhook
    sys.breakpointhook = lambda *a, **k: calls.append(1)
    try:
        out = env.central_management_system.calculate_grid_power(-5.0, 0.0, 0.0)
    finally:
        sys.breakpointhook = old_hook
    assert calls == [1], "v2x negative demand must hit the breakpoint trap once"
    assert out == -5.0, "fall-through math is remaining = demand - solar"


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_matches_reference_through_negative_demand(seed):
    """Full-discharge v2x episodes (no PV, no battery) drive total demand
    negative; engine and live reference (breakpoint disabled) must stay
    step-exact through the whole region, and the region must actually be hit."""
    rng = np.random.RandomState(500 + seed)
    # full discharge on every charger — the strongest possible negative demand
    actions = [rng.uniform(-1.0, -0.5, size=4) for _ in range(24)]
    ref, eng = run_pair(V2X_KW, actions, seed=seed, pv_shift=0.0)
    assert_trajectories_match(ref, eng, f"q4/full-discharge/{seed}")

    demand = [
        float(i.total_charging_power) + float(i.total_discharging_power)
        for i in eng["infos"]
    ]
    assert min(demand) < 0, (
        "episode never drove total demand negative — Q4 region untested")


def test_engine_negative_demand_with_battery_matches_reference():
    """Negative demand flowing into the BESS charge/discharge path + DoD
    penalty (the battery-enabled half of the Q4 fall-through)."""
    kw = dict(V2X_KW, battery_system_available_in_model=True)
    rng = np.random.RandomState(9)
    actions = [
        np.concatenate([rng.uniform(-1.0, -0.4, size=4), rng.uniform(-1.0, 1.0, size=1)])
        for _ in range(24)
    ]
    ref, eng = run_pair(kw, actions, seed=21, pv_shift=0.0)
    assert_trajectories_match(ref, eng, "q4/battery/full-discharge")
    demand = [
        float(i.total_charging_power) + float(i.total_discharging_power)
        for i in eng["infos"]
    ]
    assert min(demand) < 0
