"""Benchmark: aggregate env-steps/s of the batched engine.

Measures the BASELINE.json headline metric — env-steps/s with 4096 vectorized
envs — on the default reference configuration (8 chargers, PV + battery, 1h,
sparse penalties; reference ctor defaults, envs/smart_nanogrid_environment.py:32-34)
running the RBC policy closed-loop fully on device.  Each simulated day
includes a fresh day-schedule generation + reset + a full 24-step day through
:func:`core.rollout.fused_day_rollout`, matching what the reference does per
episode (generate_new_initial_values=True path).

Baseline: the reference pure-Python env measured at 1,699 steps/s on one CPU
core (single env, 8ch b-pv, including its per-episode day generation and JSON
telemetry dumps — solvers/RL training drives exactly that loop).

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Other modes: ``--all`` (every path into BENCH_TABLE.json), ``--train-profile``
(PPO update phases), ``--scaling`` (weak scaling over this platform's devices).
"""

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.utils.compile_cache import enable_compile_cache

REFERENCE_STEPS_PER_SEC = 1699.0  # see module docstring

BATCH = 4096
NUM_CALLS_TIMED = 3


def device_info() -> dict:
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def day_loop(config, params, policy_fn, days=50, batch=BATCH):
    """``run(i)``: ``days`` days scanned in one jitted call, each a fresh
    generation + reset of ``batch`` envs and one ``fused_day_rollout`` with
    ``policy_fn``; returns the mean day return."""
    from smart_nanogrid_gym_tpu.core.rollout import fused_day_rollout
    from smart_nanogrid_gym_tpu.core.transition import reset as core_reset

    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), params)
    reset_fn = jax.vmap(functools.partial(core_reset, config))

    @jax.jit
    def run(i):
        def day(carry, j):
            keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i * 997 + j), batch)
            states, _ = reset_fn(bparams, keys, None, None)
            _, (_, rewards, _) = fused_day_rollout(
                config, bparams, states, policy_fn,
                jax.random.fold_in(jax.random.PRNGKey(1), j),
            )
            return carry, rewards.sum(axis=0).mean()
        _, r = jax.lax.scan(day, 0, jnp.arange(days))
        return r.mean()

    return lambda i: run(i).block_until_ready()


def bench_rbc_days(config, params, days=50, batch=BATCH):
    """Headline: env-steps/s of fresh generation + the fused XLA day with the
    RBC policy, ``days`` days per call."""
    from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn

    rbc = make_rbc_policy_fn(config)
    return _timeit(day_loop(config, params, lambda ob, k: rbc(ob), days, batch),
                   batch * config.steps_per_day * days, calls=NUM_CALLS_TIMED)


def bench_scaling(config, params, out_path="SCALING.json"):
    """Weak-scaling sweep of the zero-collective sharded rollout at a fixed
    per-device batch over mesh sizes 1..N of this process's own devices
    (one process: a second JAX process would reserve the cards' memory
    again).  Writes ``out_path`` and prints one JSON line."""
    from smart_nanogrid_gym_tpu.parallel.distributed import (
        initialize_distributed, scaling_sweep, write_scaling_report)

    initialize_distributed()
    records = scaling_sweep(config, params, batch_per_device=BATCH)
    meta = {"device": device_info()}
    write_scaling_report(records, out_path, meta=meta)
    print(json.dumps({"records": records, **meta}))


def _timeit(fn, work_steps, calls=3):
    fn(0)
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i + 1)
    return work_steps * calls / (time.perf_counter() - t0)


def bench_all(config, params, out_path="BENCH_TABLE.json"):
    """Measure every benchmark path; write one JSON."""
    from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic

    results = {}
    net = ActorCritic(action_dim=config.num_actions)
    net_params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, config.obs_dim)))
    low, high = config.action_bounds()
    low, high = jnp.asarray(low), jnp.asarray(high)

    def policy(ob, key):
        mean, _, _ = net.apply(net_params, ob)
        return jnp.clip(mean, low, high)

    # 1. XLA generation + fused XLA day scan, RBC
    results["xla_gen_plus_fused_day"] = bench_rbc_days(config, params)

    # 2. policy-in-the-loop, fused XLA
    results["xla_policy_in_loop"] = _timeit(
        day_loop(config, params, policy), BATCH * config.steps_per_day * 50)

    # 3. training updates — the reference's ACTUAL workload (1.02M env steps
    # of PPO training per script run, solvers/RL/ppo_train.py:94-102).
    # Measured two ways: scanned (updates_per_call scanned inside one program,
    # the deployment shape — 2,125 sequential updates per reference run) and
    # unamortized (one dispatch per update, so the dispatch overhead is
    # visible, not hidden).
    from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner

    learner = PPOLearner(config, PPOConfig())  # SB3 defaults: 10 epochs x 4 mb
    ppo_state = learner.init(jax.random.PRNGKey(0), params, batch_size=BATCH)
    steps_per_update = BATCH * config.steps_per_day

    PPO_UPDATES = 25
    train_many = learner.build_train_many(PPO_UPDATES)

    def ppo_many(i):
        jax.block_until_ready(train_many(ppo_state, learner.nanogrid_params_batched))

    results["ppo_train_update"] = _timeit(ppo_many, steps_per_update * PPO_UPDATES)

    train_one = learner.build_train_step()

    def ppo_one(i):
        jax.block_until_ready(train_one(ppo_state, learner.nanogrid_params_batched))

    results["ppo_train_update_unamortized"] = _timeit(ppo_one, steps_per_update)

    # DDPG: collect one day + 24 gradient steps (batch 256) per update
    from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig, DDPGLearner

    dlearner = DDPGLearner(config, DDPGConfig(buffer_days=10))
    ddpg_state = dlearner.init(jax.random.PRNGKey(1), params, batch_size=BATCH)
    DDPG_UPDATES = 25
    ddpg_many = dlearner.build_train_many(DDPG_UPDATES)

    def ddpg_call(i):
        jax.block_until_ready(ddpg_many(ddpg_state, dlearner.nanogrid_params_batched))

    results["ddpg_train_update"] = _timeit(ddpg_call, steps_per_update * DDPG_UPDATES)

    del ppo_state, ddpg_state  # free the replay buffer before the native runs

    # 4. native engines (CPU serving)
    import numpy as _np

    from smart_nanogrid_gym_tpu.native import (
        NativeBatchEngine, NativeEngine, generate_schedule_native)

    sched = generate_schedule_native(0, config.num_chargers, config.time_interval)
    eng = NativeEngine(config)
    eng.reset(sched, batt_soc=0.5)
    a1 = _np.full(config.num_actions, 0.3)
    t0 = time.perf_counter()
    for _ in range(20_000):
        eng.step(a1)
    results["native_single_env"] = 20_000 / (time.perf_counter() - t0)

    NB = 1024
    fleet = NativeBatchEngine(config, NB)
    fleet.reset([generate_schedule_native(i, config.num_chargers) for i in range(NB)])
    ab = _np.broadcast_to(a1, (NB, config.num_actions)).copy()
    for _ in range(24):
        fleet.step_batch(ab)
    t0 = time.perf_counter()
    for _ in range(10 * 24):
        fleet.step_batch(ab)
    results["native_batched_1024"] = NB * 10 * 24 / (time.perf_counter() - t0)

    with open(out_path, "w") as fp:
        json.dump({"batch": BATCH, "config": "8ch b-pv sparse 1h",
                   "unit": "env-steps/s", "device": device_info(),
                   "paths": results}, fp, indent=2)
    for k, v in results.items():
        print(json.dumps({"path": k, "steps_per_sec": v}))


def bench_train_profile(config, params, out_path="TRAIN_PROFILE.json"):
    """Phase breakdown of the PPO training update (VERDICT r3 #2).

    Times three scanned programs over the same state — rollout only,
    rollout+GAE, and the full update (rollout+GAE+the 10-epoch×4-minibatch
    sweep) — and reports per-phase time by subtraction.  Every program scans
    REPS iterations so the dispatch round-trip amortizes out.
    """
    from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner

    learner = PPOLearner(config, PPOConfig())
    state = learner.init(jax.random.PRNGKey(0), params, batch_size=BATCH)
    env_params = learner.nanogrid_params_batched
    REPS = 25
    steps = BATCH * config.steps_per_day * REPS

    def scanned(include_gae):
        @jax.jit
        def run(state):
            def body(carry, _):
                key, env_states, obs = carry
                key, k = jax.random.split(key)
                env_states, obs, traj = learner._rollout(
                    state.params, env_params, env_states, obs, k)
                t_obs, t_act, t_logp, t_val, t_rew, t_done = traj
                if include_gae:
                    _, _, last_value = learner.network.apply(state.params, obs)
                    adv, ret = learner._gae(t_rew, t_val, t_done, last_value)
                    out = adv.mean() + ret.mean()
                else:
                    out = t_rew.mean()
                return (key, env_states, obs), out

            _, outs = jax.lax.scan(
                body, (state.key, state.env_states, state.last_obs), length=REPS)
            return outs.mean()

        return lambda i: run(state).block_until_ready()

    full = learner.build_train_many(REPS)

    def timed(fn):
        fn(0)
        t0 = time.perf_counter()
        for i in range(NUM_CALLS_TIMED):
            fn(i + 1)
        return (time.perf_counter() - t0) / NUM_CALLS_TIMED

    t_rollout = timed(scanned(include_gae=False))
    t_gae = timed(scanned(include_gae=True))
    t_full = timed(lambda i: jax.block_until_ready(full(state, env_params)))

    report = {
        "batch": BATCH,
        "updates_per_call": REPS,
        "env_steps_per_call": steps,
        "phases_sec_per_update": {
            "rollout": t_rollout / REPS,
            "gae": max(t_gae - t_rollout, 0.0) / REPS,
            "update_sweep_10ep_x_4mb": max(t_full - t_gae, 0.0) / REPS,
            "total": t_full / REPS,
        },
        "train_env_steps_per_sec": steps / t_full,
        "device": device_info(),
    }
    with open(out_path, "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report))


def main():
    enable_compile_cache()
    config = NanogridConfig(
        num_chargers=8,
        pv_system=True,
        battery_system=True,
        penalty_mode="sparse",
        time_interval=1.0,
    )
    params = make_params(config, dtype=jnp.float32)

    if "--scaling" in sys.argv:
        bench_scaling(config, params)
        return
    if "--all" in sys.argv:
        bench_all(config, params)
        return
    if "--train-profile" in sys.argv:
        bench_train_profile(config, params)
        return

    steps_per_sec = bench_rbc_days(config, params)
    print(
        json.dumps(
            {
                "metric": "env_steps_per_sec_per_chip_4096envs",
                "value": steps_per_sec,
                "unit": "env-steps/s",
                "vs_baseline": steps_per_sec / REFERENCE_STEPS_PER_SEC,
                "device": device_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
