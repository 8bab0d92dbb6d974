"""Day-schedule generation and loading.

Two producers of :class:`..core.state.DaySchedule`:

1. :func:`generate_schedule` — a counter-based ``jax.random`` re-expression of the
   reference's per-charger day generation loop
   (utils/charging_station.py:200-279).  The reference consumes a *global*
   MT19937 stream with order-dependent, conditionally-consumed draws (SURVEY.md
   Q5) — that design cannot scale to thousands of parallel envs, so this
   build draws a fixed block of uniforms per (charger, timestep) from a
   counter-based key and reproduces the *distributional* semantics exactly:

   - arrival: Bernoulli via ``round(U - 0.1) == 1`` ⇔ ``U > 0.6``
     (charging_station.py:214; numpy's round-half-to-even makes P(arrival)=0.4),
   - arrival SoC ~ uniform(0.1, 0.9) (:257-259),
   - the unconditionally *discarded* requested-SoC draw (:219) is simply not
     drawn — counter-based keys make stream-position bookkeeping unnecessary,
   - capacity ~ randint(15, 120) iff different capacities enabled, else 40
     (:220-225, :267-269),
   - requested SoC ~ uniform(min(soc+0.1, 1), 1) iff enabled, else 1.0
     (:227-231, :261-265),
   - departure ~ randint(t + 4/Δt, min(t + 10/Δt, T + 1/Δt)); **no draw** when
     low ≥ high (returns low — departures can exceed the day, SURVEY.md Q6)
     (:271-279).

2. :func:`schedule_from_arrays` / :func:`load_initial_values_json` — host-side
   exact replay of a recorded day (the reference's ``initial_values.json``
   round-trip, charging_station.py:119-136), reproducing the reference's
   list-membership lookups bit-for-bit so oracle trajectory tests can drive both
   engines from an identical day.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from .config import NanogridConfig
from .params import NanogridParams
from .state import DaySchedule


def generate_schedule(
    key: jnp.ndarray,
    config: NanogridConfig,
    params: NanogridParams,
    uniforms: jnp.ndarray | None = None,
) -> DaySchedule:
    """Generate one day's schedule for all N chargers (jit/vmap-friendly).

    ``uniforms`` optionally supplies the ``(T, 5, N)`` uniform block instead of
    drawing it from ``key`` (tests pin the generator's distribution through
    it).
    """
    N = config.num_chargers
    T = config.steps_per_day
    L = config.table_len
    dtype = params.dtype

    k4 = int(4 / config.time_interval)
    k10 = int(10 / config.time_interval)
    k1 = int(1 / config.time_interval)

    # One block of uniforms per (timestep, draw-kind, charger).
    u = uniforms if uniforms is not None else jax.random.uniform(key, (T, 5, N), dtype=dtype)
    ts = jnp.arange(T, dtype=jnp.int32)

    def scan_step(carry, xs):
        present, dep, cap, req = carry
        t, u_t = xs
        u_arr, u_soc, u_cap, u_req, u_dep = u_t

        arrives = jnp.logical_and(jnp.logical_not(present), u_arr > params.arrival_threshold)

        soc_t = params.soc_low + params.soc_span * u_soc
        if config.different_battery_capacities:
            cap_new = params.cap_low + jnp.floor(u_cap * params.cap_span)
        else:
            cap_new = jnp.broadcast_to(params.default_capacity, (N,)).astype(dtype)
        if config.requested_state_of_charge:
            soc_prime = jnp.minimum(soc_t + 0.1, 1.0)
            req_new = soc_prime + (1.0 - soc_prime) * u_req
        else:
            req_new = jnp.ones((N,), dtype=dtype)

        low = t + k4
        high = jnp.minimum(t + k10, T + k1)
        span = jnp.maximum(high - low, 1).astype(dtype)
        dep_draw = low + jnp.floor(u_dep * span).astype(jnp.int32)
        dep_new = jnp.where(low >= high, low, dep_draw)

        present = jnp.logical_or(present, arrives)
        dep = jnp.where(arrives, dep_new, dep)
        cap = jnp.where(arrives, cap_new, cap)
        req = jnp.where(arrives, req_new, req)

        occupied = jnp.logical_and(present, t < dep)

        out = (
            occupied,
            jnp.where(occupied, cap, 0.0),
            jnp.where(occupied, req, 0.0),
            jnp.where(arrives, soc_t, 0.0),
            arrives,
            jnp.where(occupied, (dep - t).astype(dtype), 0.0),
            jnp.logical_and(occupied, dep == t + 1),
            jnp.logical_and(occupied, dep <= t + 3),
        )
        # A charger whose vehicle departed is immediately available next step.
        return (occupied, dep, cap, req), out

    init = (
        jnp.zeros((N,), dtype=bool),
        jnp.zeros((N,), dtype=jnp.int32),
        jnp.zeros((N,), dtype=dtype),
        jnp.zeros((N,), dtype=dtype),
    )
    _, outs = jax.lax.scan(scan_step, init, (ts, u))
    occ, cap, req, soc0, is_arr, dep_obs, m1, m3 = outs

    def to_table(x, out_dtype=dtype):
        # (T, N) -> (N, L) with the trailing always-zero column (reference
        # zeros(25) arrays, utils/charger.py:16-19).
        x = x.T.astype(out_dtype)
        return jnp.pad(x, ((0, 0), (0, L - T)))

    mask = params.charger_mask[:, None]
    return DaySchedule(
        occupancy=to_table(occ) * mask,
        capacity=to_table(cap) * mask,
        requested_soc=to_table(req) * mask,
        soc_init=to_table(soc0) * mask,
        is_arrival=to_table(is_arr) * mask,
        dep_obs=to_table(dep_obs) * mask,
        mask_departing=to_table(m1) * mask,
        mask_departing3=to_table(m3) * mask,
    )


# ---------------------------------------------------------------------------
# Host-side exact replay from recorded schedules
# ---------------------------------------------------------------------------


def schedule_from_arrays(
    config: NanogridConfig,
    soc: np.ndarray,
    arrivals: list[list[int]],
    departures: list[list[int]],
    occupancy: np.ndarray,
    capacities: np.ndarray,
    requested_soc: np.ndarray | None = None,
    dtype=np.float64,
) -> DaySchedule:
    """Build a DaySchedule from reference-format day arrays (host side).

    Inputs use the reference's ``initial_values.json`` layout
    (charging_station.py:119-136,164-180).  Lookup tables reproduce the
    reference's per-step list searches exactly:

    - ``dep_obs[c, t]`` = first departure ≥ t minus t while occupied
      (charging_station.py:92-112),
    - ``mask_departing[c, t]`` = occupied and t+1 ∈ departures[c] (:79-84),
    - ``mask_departing3[c, t]`` = occupied and {t+1, t+2, t+3} ∩ departures[c]
      (:86-90 — the ``n`` argument is ignored by the reference, SURVEY.md Q10),
    - ``is_arrival[c, t]`` = t ∈ arrivals[c] (the *charger-level* list the
      Charger uses, charger.py:42,62,112).
    """
    N, T, L = config.num_chargers, config.steps_per_day, config.table_len

    def fit(arr):
        arr = np.asarray(arr, dtype=dtype)
        out = np.zeros((N, L), dtype=dtype)
        cols = min(L, arr.shape[1])
        out[:, :cols] = arr[:, :cols]
        return out

    occ = fit(occupancy)
    out_soc = fit(soc)
    caps = fit(capacities)
    if requested_soc is None:
        req = np.where(occ > 0, 1.0, 0.0).astype(dtype)
    else:
        req = fit(requested_soc)

    is_arr = np.zeros((N, L), dtype=dtype)
    dep_obs = np.zeros((N, L), dtype=dtype)
    m1 = np.zeros((N, L), dtype=dtype)
    m3 = np.zeros((N, L), dtype=dtype)
    for c in range(N):
        arr_set = set(int(a) for a in arrivals[c])
        deps = [int(d) for d in departures[c]]
        dep_set = set(deps)
        for t in range(T):
            if t in arr_set:
                is_arr[c, t] = 1.0
            if occ[c, t] > 0:
                for d in deps:
                    if t <= d:
                        dep_obs[c, t] = d - t
                        break
                if (t + 1) in dep_set:
                    m1[c, t] = 1.0
                if (t + 1) in dep_set or (t + 2) in dep_set or (t + 3) in dep_set:
                    m3[c, t] = 1.0

    return DaySchedule(
        occupancy=jnp.asarray(occ),
        capacity=jnp.asarray(caps),
        requested_soc=jnp.asarray(req),
        soc_init=jnp.asarray(out_soc),
        is_arrival=jnp.asarray(is_arr),
        dep_obs=jnp.asarray(dep_obs),
        mask_departing=jnp.asarray(m1),
        mask_departing3=jnp.asarray(m3),
    )


def schedule_from_reference_seed(
    seed: int, config: NanogridConfig, dtype=np.float64
) -> DaySchedule:
    """Day schedule **bit-identical** to what the reference generates under
    ``np.random.seed(seed)`` (charging_station.py:152-186), via the native C++
    MT19937 generator (smart_nanogrid_gym_tpu.native).  Combined with
    :func:`..core.transition.reset` this yields bitwise trajectory replication
    from the bare seed — the BASELINE.md correctness north star."""
    from ..native import generate_schedule_native

    tables = generate_schedule_native(
        seed,
        config.num_chargers,
        config.time_interval,
        table_len=config.table_len,
        different_capacities=config.different_battery_capacities,
        requested_soc=config.requested_state_of_charge,
    )
    as_dtype = lambda name: jnp.asarray(tables[name].astype(dtype))
    return DaySchedule(
        occupancy=as_dtype("occupancy"),
        capacity=as_dtype("capacity"),
        requested_soc=as_dtype("requested_soc"),
        soc_init=as_dtype("soc_init"),
        is_arrival=as_dtype("is_arrival"),
        dep_obs=as_dtype("dep_obs"),
        mask_departing=as_dtype("mask_departing"),
        mask_departing3=as_dtype("mask_departing3"),
    )


def load_initial_values_json(path: str, config: NanogridConfig, dtype=np.float64) -> DaySchedule:
    """Load a reference-format ``initial_values.json`` day
    (keys per charging_station.py:173-180)."""
    with open(path) as fp:
        initials = json.load(fp)
    return schedule_from_arrays(
        config,
        soc=np.asarray(initials["SOC"]),
        arrivals=initials["Arrivals"],
        departures=initials["Departures"],
        occupancy=np.asarray(initials["Charger_occupancy"]),
        capacities=np.asarray(initials["Vehicle_capacities"]),
        requested_soc=np.asarray(initials["Requested_SOC"]) if "Requested_SOC" in initials else None,
        dtype=dtype,
    )


def schedule_to_json_dict(schedule: DaySchedule, config: NanogridConfig) -> dict:
    """Serialise a DaySchedule to the reference's ``initial_values.json`` layout
    (charging_station.py:173-180) for round-tripping and notebook compatibility."""
    T = config.steps_per_day
    is_arr = np.asarray(schedule.is_arrival)
    dep_obs = np.asarray(schedule.dep_obs)
    arrivals, departures = [], []
    for c in range(config.num_chargers):
        arr_ts = [int(t) for t in range(T) if is_arr[c, t] > 0]
        arrivals.append(arr_ts)
        departures.append([int(t + dep_obs[c, t]) for t in arr_ts])
    return {
        "SOC": np.asarray(schedule.soc_init).tolist(),
        "Arrivals": arrivals,
        "Departures": departures,
        "Charger_occupancy": np.asarray(schedule.occupancy).tolist(),
        "Vehicle_capacities": np.asarray(schedule.capacity).tolist(),
        "Requested_SOC": np.asarray(schedule.requested_soc).tolist(),
    }
