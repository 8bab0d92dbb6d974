"""Engine API tests: jit/vmap batching, scan rollouts, RBC policy."""

import numpy as np
import jax
import jax.numpy as jnp

import oracle
from smart_nanogrid_gym_tpu.core import NanogridConfig, SmartNanogridTPU, make_params
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn, rbc_policy


def test_vmap_batch_matches_single():
    """A vmapped batch of identical envs must reproduce the single-env path."""
    env = SmartNanogridTPU(
        NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    )
    params = env.default_params(dtype=jnp.float64)
    B = 16
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    bparams = env.broadcast_params(params, B)
    states, obs = env.reset_batch(bparams, keys)
    assert obs.shape == (B, env.config.obs_dim)

    actions = jnp.tile(jnp.asarray([0.5, 0.2, 0.8, 0.1, -0.3], jnp.float64), (B, 1))
    res = env.step_batch(bparams, states, actions)
    assert res.obs.shape == (B, env.config.obs_dim)
    assert res.reward.shape == (B,)

    # env 3 stepped alone must equal row 3 of the batch
    state3 = jax.tree.map(lambda x: x[3], states)
    res3 = env.step(params, state3, actions[3])
    np.testing.assert_allclose(np.asarray(res3.obs), np.asarray(res.obs[3]), rtol=1e-12)
    np.testing.assert_allclose(float(res3.reward), float(res.reward[3]), rtol=1e-12)


def test_rollout_day_scan():
    env = SmartNanogridTPU(NanogridConfig(num_chargers=4, pv_system=True, battery_system=True))
    params = env.default_params(dtype=jnp.float64)
    B = 8
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    bparams = env.broadcast_params(params, B)
    states, obs = env.reset_batch(bparams, keys)

    policy = make_rbc_policy_fn(env.config)
    final_state, final_obs, (obs_traj, rew_traj, done_traj, info) = env.rollout_day(
        bparams, states, lambda ob, k: policy(ob), obs
    )
    T = env.config.steps_per_day
    assert rew_traj.shape == (T, B)
    assert bool(done_traj[-1].all()) and not bool(done_traj[:-1].any())
    # after a full day the env rolls t back to 0 (reference Q8 day rollover)
    assert (np.asarray(final_state.t) == 0).all()
    assert np.isfinite(np.asarray(rew_traj)).all()


def test_rollout_actions_matches_python_loop():
    env = SmartNanogridTPU(NanogridConfig(num_chargers=4, pv_system=False, battery_system=False))
    params = env.default_params(dtype=jnp.float64)
    state, obs = env.reset(params, jax.random.PRNGKey(2))
    T = env.config.steps_per_day
    rng = np.random.RandomState(0)
    actions = jnp.asarray(rng.uniform(0, 1, (T, 4)))

    _, (obs_traj, rew_traj, _, _) = env.rollout_actions(params, state, actions, batched=False)

    state2, _ = env.reset(params, jax.random.PRNGKey(2))
    rewards = []
    for t in range(T):
        res = env.step(params, state2, actions[t])
        state2 = res.state
        rewards.append(float(res.reward))
    np.testing.assert_allclose(np.asarray(rew_traj), rewards, rtol=1e-12)


def test_rbc_matches_reference_rbc():
    """Vectorized RBC must reproduce the reference RBC decision rule on the
    8-charger PV-on battery-off layout it was written for
    (solvers/RBC/rbc.py:6-29)."""
    oracle.setup_reference()
    import importlib.util

    spec = importlib.util.spec_from_file_location("ref_rbc", f"{oracle.REFERENCE_ROOT}/solvers/RBC/rbc.py")
    ref_rbc_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_rbc_mod)
    ref = ref_rbc_mod.RBC()
    ref.NUMBER_OF_CHARGERS = 8

    config = NanogridConfig(num_chargers=8, pv_system=True, battery_system=False)
    assert config.obs_dim == 24  # 2 + 6 + 8 soc + 8 dep

    rng = np.random.RandomState(5)
    for _ in range(50):
        states = rng.uniform(0, 1, 24)
        # reference treats exact-zero departures specially; plant some zeros
        zero_idx = rng.choice(8, size=3, replace=False)
        states[16 + zero_idx] = 0.0
        ref_actions = np.asarray(ref.select_action(states), dtype=np.float64)
        eng_actions = np.asarray(rbc_policy(config, jnp.asarray(states)))
        np.testing.assert_allclose(eng_actions, ref_actions, rtol=1e-12)


def test_heterogeneous_batch_varied_params():
    """BASELINE config 3: per-env charger masks and battery capacities under one
    compiled step."""
    config = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True)
    env = SmartNanogridTPU(config)
    params = env.default_params(dtype=jnp.float64)
    B = 8
    bparams = env.broadcast_params(params, B)
    # vary active charger counts 1..8 and battery capacity per env
    masks = np.zeros((B, 8))
    for i in range(B):
        masks[i, : i + 1] = 1.0
    bparams = bparams._replace(
        charger_mask=jnp.asarray(masks, jnp.float64),
        batt_capacity=jnp.linspace(40, 120, B).astype(jnp.float64),
    )
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    states, obs = env.reset_batch(bparams, keys)
    # inactive chargers contribute zero observation entries
    occ = np.asarray(states.schedule.occupancy)
    for i in range(B):
        assert occ[i, i + 1 :].sum() == 0

    actions = jnp.ones((B, 9), jnp.float64)
    res = env.step_batch(bparams, states, actions)
    assert np.isfinite(np.asarray(res.reward)).all()
    # acting on masked-out chargers must not add nonexistent-vehicle markers
    info = res.info
    marker = np.asarray(info.discharging_nonexistent_vehicles_penalty)
    occ0 = occ[:, :, 0]
    for i in range(B):
        empty_active = ((occ0[i] == 0) & (masks[i] > 0)).sum()
        assert marker[i] == 100.0 * empty_active


def test_day_rollover_keeps_schedule_and_battery():
    """Reference Q8: day end resets t and redraws the PV shift but keeps the
    schedule; battery SoC carries into the new day."""
    env = SmartNanogridTPU(NanogridConfig(num_chargers=4, pv_system=True, battery_system=True))
    params = env.default_params(dtype=jnp.float64)
    state, obs = env.reset(params, jax.random.PRNGKey(4))
    occ_before = np.asarray(state.schedule.occupancy).copy()
    shift_before = float(state.pv_shift)
    T = env.config.steps_per_day
    for t in range(T):
        res = env.step(params, state, jnp.asarray([0.3, 0.3, 0.3, 0.3, 0.5], jnp.float64))
        state = res.state
    assert bool(res.done)
    assert int(state.t) == 0
    np.testing.assert_array_equal(np.asarray(state.schedule.occupancy), occ_before)
    batt = float(state.batt_soc)
    assert batt > 0.5  # charged all day
    # next-day step 0 records the carried-over battery SoC as the day-initial
    res2 = env.step(params, state, jnp.zeros(5, jnp.float64))
    assert float(res2.info.initial_battery_state_of_charge) == batt
