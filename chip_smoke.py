"""Smoke run of the main paths on an NVIDIA GPU, checked against the plain reference.

Run from the repository root:

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the env-sharded PPO learner only

The deployment is the reference one (bench.py): 8 chargers with PV and a
battery, sparse vehicle penalties, a 1 h step, f32 params, 4096 envs, and the
SB3-default nets (PPO 64x64 tanh actor-critic; DDPG 400x300 relu actor and
critic, batch 256) with random weights from ``--seed``.

Phases (one card): ``rbc_rollout``, ``policy_rollout``, ``ppo``, ``ddpg``,
``gym_adapter``, ``at_scale``.  Each prints one JSON line with its compile
seconds, steady-state env-steps/s, the device's ``peak_bytes_in_use`` so far
(a process-lifetime peak) and its deviations from the reference next to their
tolerances.  A failed check raises.  The last line of standard output,
``{"ok": true, "device": {...}}``, is printed only after every phase passed.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from smart_nanogrid_gym_tpu.compat.gym_adapter import SmartNanogridEnv
from smart_nanogrid_gym_tpu.core import NanogridConfig, SmartNanogridTPU, make_params
from smart_nanogrid_gym_tpu.core.rollout import fused_day_rollout
from smart_nanogrid_gym_tpu.core.transition import step as core_step
from smart_nanogrid_gym_tpu.parallel.mesh import ENV_AXIS, make_mesh
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig, DDPGLearner
from smart_nanogrid_gym_tpu.solvers.evaluator import evaluate_policy_at_scale
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
CHECK_ENVS = 64   # envs of each rollout checked against the float64 reference
TIMED_CALLS = 3

# f32 engine against float64 core/transition.step, teacher-forced with the
# engine's actions (tests/test_precision.py pins these over every model
# variant and penalty mode).  A reward sums ~10 terms — grid cost
# |energy|·price and squared penalty gaps (Δ·10)², each up to ~1e2 — of a
# few f32 operations each: with f32's unit roundoff of 6e-8 that bounds the
# error near 1e-4 (worst on the CPU over the 16 configs: 7e-5).
# Observations lie in [0, 1] and both sides cast them to f32: a few ulps of 1
# (worst on the CPU: 2.4e-7).
REWARD_RTOL, REWARD_ATOL = 2e-6, 2e-4
OBS_ATOL = 1e-6

# First learner update on the card against the same update on the CPU from
# the same state, both at "highest" matmul precision.  The update is 40
# (PPO) or 24 (DDPG) Adam steps; Adam's g/(|g|+eps) amplifies last-bit
# differences where a gradient is near zero, so parameters are compared by
# the norm of their difference relative to the norm of the update itself.
UPDATE_REL_TOL = 1e-2
RETURN_RTOL = 1e-5   # the rollout's mean return precedes every gradient step

# Four sharded cards against the same global batch on one card, run two ways:
# the same per-shard program (the same update to rounding), and the unsharded
# learner.  All three roll out the same days with the same noise, so mean
# returns agree to rounding.  The unsharded learner's minibatches are not
# stratified by shard (PPOLearner's docstring), so its update differs by the
# noise of the minibatch draw, which shrinks as 1/sqrt(envs per minibatch):
# c/sqrt(n) with c = 0.7-1.2 on 4 CPU devices at n = 16, 256 and 1024.
SHARDED_RETURN_RTOL = 1e-5
SHARDED_UPDATE_REL_TOL = 1e-2


def unsharded_update_rel_tol(envs_per_minibatch: int) -> float:
    return 3.0 / np.sqrt(envs_per_minibatch)

# at-scale evaluation on the card against the same call on the CPU
AT_SCALE_RTOL = 1e-4


def reference_config() -> NanogridConfig:
    return NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                          penalty_mode="sparse", time_interval=1.0)


def gpu_devices() -> list:
    """The GPUs JAX sees; exits non-zero when the default backend is not a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX default backend is "
                         f"{devices[0].platform!r})")
    return devices


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def peak_bytes(device):
    stats = device.memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def compile_and_time(jitted, args, calls=TIMED_CALLS):
    """Compile ``jitted`` for ``args``; return ``(compiled, out, compile_s,
    seconds per steady-state call)``."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(calls):
        out = jax.block_until_ready(compiled(*args))
    return compiled, out, compile_s, (time.perf_counter() - t0) / calls


def broadcast(params, batch):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), params)


def first(tree, n):
    return jax.tree.map(lambda x: np.asarray(x[:n]), tree)


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------


def f64_teacher_forced(config, state0, actions, cpu):
    """Step ``core/transition.step`` in float64 on ``cpu`` from the engine's
    initial state, feeding it at every step the action the engine took
    (teacher forcing), so a select that flips on one side cannot steer the
    other side's later actions.  ``state0`` leaves have a leading env axis E;
    ``actions`` is (T, E, A).  Returns float64 numpy ``(rewards (T, E), obs
    (T, E, obs_dim))``."""
    def to64(x):
        x = np.asarray(x)
        return jnp.asarray(x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x)

    with jax.enable_x64(True), jax.default_device(cpu):
        bparams = broadcast(make_params(config, dtype=jnp.float64), actions.shape[1])
        state = jax.tree.map(to64, state0)
        step = jax.jit(jax.vmap(functools.partial(core_step, config)))
        rewards, obs = [], []
        for a in np.asarray(actions, np.float64):
            res = step(bparams, state, jnp.asarray(a))
            state = res.state
            rewards.append(np.asarray(res.reward, np.float64))
            obs.append(np.asarray(res.obs, np.float64))
    return np.stack(rewards), np.stack(obs)


def rollout_deviation(config, state0, actions, rewards, obs, cpu) -> dict:
    """Per-step max |Δreward| and |Δobs| of an engine rollout (first envs,
    numpy) against :func:`f64_teacher_forced`; raises past the tolerances."""
    ref_r, ref_o = f64_teacher_forced(config, state0, actions, cpu)
    d_r = np.abs(np.asarray(rewards, np.float64) - ref_r)
    d_o = np.abs(np.asarray(obs, np.float64) - ref_o)
    out = {
        "max_abs_dreward_per_step": d_r.max(axis=1).tolist(),
        "max_abs_dobs_per_step": d_o.max(axis=(1, 2)).tolist(),
        "reward_tol": f"{REWARD_ATOL} + {REWARD_RTOL}*|r|",
        "obs_tol": OBS_ATOL,
    }
    if not (d_r <= REWARD_ATOL + REWARD_RTOL * np.abs(ref_r)).all():
        raise AssertionError(f"rewards off the float64 reference: {out}")
    if not (d_o <= OBS_ATOL).all():
        raise AssertionError(f"observations off the float64 reference: {out}")
    return out


def update_deviation(p_dev, p_ref, p0) -> dict:
    """Distance of one update's params from the reference update's, relative
    to the size of the reference update."""
    flat = lambda t: np.concatenate(
        [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(t)])
    d = flat(p_dev) - flat(p_ref)
    u = flat(p_ref) - flat(p0)
    return {"max_abs": float(np.abs(d).max()),
            "rel_to_update": float(np.linalg.norm(d) / np.linalg.norm(u))}


def rel_diff(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def vmapped_shard_map(f, *, mesh, in_specs, out_specs, **_):
    """Stand-in for ``jax.shard_map`` that runs all ``mesh.size`` shards on
    one device: global arrays are split along their ``envs`` axis and the
    per-shard body is vmapped over that axis name, so ``axis_index`` and
    ``pmean`` mean the same as on the mesh."""
    n = mesh.size
    is_spec = lambda s: isinstance(s, P)

    def axis(spec):
        return next((i for i, a in enumerate(spec) if a == ENV_AXIS), None)

    def split(spec, sub):
        a = axis(spec)
        if a is None:
            return sub
        return jax.tree.map(
            lambda x: x.reshape(x.shape[:a] + (n, x.shape[a] // n) + x.shape[a + 1:]), sub)

    def merge(spec, sub):
        a = axis(spec)
        if a is None:
            return jax.tree.map(lambda x: x[0], sub)
        return jax.tree.map(
            lambda x: jnp.moveaxis(x, 0, a).reshape(
                x.shape[1:a + 1] + (n * x.shape[a + 1],) + x.shape[a + 2:]), sub)

    def run(*args):
        in_axes = tuple(jax.tree.map(axis, in_specs, is_leaf=is_spec))
        split_args = jax.tree.map(split, tuple(in_specs), args, is_leaf=is_spec)
        outs = jax.vmap(f, in_axes=in_axes, out_axes=0, axis_name=ENV_AXIS)(*split_args)
        return jax.tree.map(merge, out_specs, outs, is_leaf=is_spec)

    return run


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------


def phase_rbc_rollout(device, cpu, seed=0, batch=BATCH, config=None):
    """``SmartNanogridTPU.reset_batch`` + ``rollout_day`` with the RBC policy."""
    config = config or reference_config()
    with jax.enable_x64(False), jax.default_device(device):
        env = SmartNanogridTPU(config)
        bparams = env.broadcast_params(env.default_params(jnp.float32), batch)
        states, obs = env.reset_batch(bparams, jax.random.split(jax.random.PRNGKey(seed), batch))
        rbc = make_rbc_policy_fn(config)
        day = jax.jit(lambda p, s, o: env.rollout_day(p, s, lambda ob, k: rbc(ob), o))
        _, out, compile_s, per_day = compile_and_time(day, (bparams, states, obs))
        state1, obs1, (obs_traj, rewards, _, info) = out
        # a continued day (no reset) after the first
        jax.block_until_ready(day(bparams, state1, obs1))
    actions = info.charger_actions
    if config.battery_system:
        actions = jnp.concatenate([actions, info.battery_action[..., None]], axis=-1)
    e = min(CHECK_ENVS, batch)
    return {
        "phase": "rbc_rollout", "envs": batch, "compile_s": compile_s,
        "env_steps_per_s": batch * config.steps_per_day / per_day,
        "peak_bytes_in_use": peak_bytes(device),
        "f64_reference": rollout_deviation(
            config, first(states, e), np.asarray(actions[:, :e]),
            np.asarray(rewards[:, :e]), np.asarray(obs_traj[:, :e]), cpu),
    }


def phase_policy_rollout(device, cpu, seed=0, batch=BATCH, config=None):
    """Fresh day generation + ``fused_day_rollout`` with the PPO actor's mean."""
    config = config or reference_config()
    with jax.enable_x64(False), jax.default_device(device):
        env = SmartNanogridTPU(config)
        bparams = env.broadcast_params(env.default_params(jnp.float32), batch)
        net = ActorCritic(action_dim=config.num_actions)
        net_params = net.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, config.obs_dim)))
        low, high = (jnp.asarray(b) for b in config.action_bounds())

        @jax.jit
        def day(p, net_params, key):
            def policy(ob, k):
                a = jnp.clip(net.apply(net_params, ob)[0], low, high)
                return a, a

            states, _ = env.reset_batch(p, jax.random.split(key, batch))
            _, (obs_traj, rewards, _, actions) = fused_day_rollout(
                config, p, states, policy, key, policy_aux=True)
            return states, obs_traj, rewards, actions

        args = (bparams, net_params, jax.random.PRNGKey(seed + 2))
        _, out, compile_s, per_day = compile_and_time(day, args)
    states, obs_traj, rewards, actions = out
    e = min(CHECK_ENVS, batch)
    return {
        "phase": "policy_rollout", "envs": batch, "compile_s": compile_s,
        "env_steps_per_s": batch * config.steps_per_day / per_day,
        "peak_bytes_in_use": peak_bytes(device),
        "f64_reference": rollout_deviation(
            config, first(states, e), np.asarray(actions[:, :e]),
            np.asarray(rewards[:, :e]), np.asarray(obs_traj[:, :e]), cpu),
    }


def check_finite(label, tree):
    for leaf in jax.tree.leaves(tree):
        if not np.isfinite(np.asarray(leaf)).all():
            raise AssertionError(f"{label}: non-finite values")


def first_update_deviation(step, state0, env_params, cpu, params_of, return_of) -> dict:
    """One learner update on the card against the same update on ``cpu`` from
    the same state, at "highest" matmul precision (asserted) and at the
    default precision, where f32 products may run in TF32 (reported)."""
    with jax.default_matmul_precision("highest"):
        s_cpu, m_cpu = step(*jax.device_put((state0, env_params), cpu))
        s_hi, m_hi = step(state0, env_params)
    s_def, m_def = step(state0, env_params)
    p0, p_cpu = params_of(state0), params_of(s_cpu)
    out = {
        precision: {"params": update_deviation(params_of(s), p_cpu, p0),
                    "mean_return_rel": rel_diff(return_of(m), return_of(m_cpu))}
        for precision, s, m in (("highest", s_hi, m_hi), ("default", s_def, m_def))
    }
    out["tol"] = {"rel_to_update": UPDATE_REL_TOL, "mean_return_rel": RETURN_RTOL}
    hi = out["highest"]
    if hi["params"]["rel_to_update"] > UPDATE_REL_TOL or hi["mean_return_rel"] > RETURN_RTOL:
        raise AssertionError(f"first update off the CPU reference: {out}")
    return out


def phase_ppo(device, cpu, seed=0, batch=BATCH, config=None, ppo=None, updates=3):
    """``PPOLearner(config, PPOConfig())`` at ``batch`` envs: ``build_train_many``."""
    config = config or reference_config()
    with jax.enable_x64(False):
        learner = PPOLearner(config, ppo or PPOConfig())
        state0 = learner.init(jax.random.PRNGKey(seed), make_params(config, dtype=jnp.float32), batch)
        state0, env_params = jax.device_put((state0, learner.nanogrid_params_batched), device)
        _, (state, metrics), compile_s, per_call = compile_and_time(
            learner.build_train_many(updates), (state0, env_params), calls=2)
        check_finite("ppo", (state.params, metrics))
        dev = first_update_deviation(learner.build_train_step(), state0, env_params, cpu,
                                     lambda s: s.params, lambda m: m.mean_return)
    return {
        "phase": "ppo", "envs": batch, "updates_per_call": updates, "compile_s": compile_s,
        "env_steps_per_s": updates * batch * config.steps_per_day / per_call,
        "peak_bytes_in_use": peak_bytes(device),
        "mean_return": np.asarray(metrics.mean_return).tolist(),
        "first_update_vs_cpu": dev,
    }


def phase_ddpg(device, cpu, seed=0, batch=BATCH, config=None, ddpg=None, updates=3):
    """``DDPGLearner(config, DDPGConfig(buffer_days=10))``: ``build_train_many``."""
    config = config or reference_config()
    with jax.enable_x64(False):
        learner = DDPGLearner(config, ddpg or DDPGConfig(buffer_days=10))
        state0 = learner.init(jax.random.PRNGKey(seed), make_params(config, dtype=jnp.float32), batch)
        state0, env_params = jax.device_put((state0, learner.nanogrid_params_batched), device)
        _, (state, metrics), compile_s, per_call = compile_and_time(
            learner.build_train_many(updates), (state0, env_params), calls=2)
        check_finite("ddpg", (state.actor_params, state.critic_params, metrics))
        dev = first_update_deviation(
            learner.build_train_step(), state0, env_params, cpu,
            lambda s: (s.actor_params, s.critic_params), lambda m: m["mean_return"])
    return {
        "phase": "ddpg", "envs": batch, "updates_per_call": updates, "compile_s": compile_s,
        "env_steps_per_s": updates * batch * config.steps_per_day / per_call,
        "peak_bytes_in_use": peak_bytes(device),
        "mean_return": np.asarray(metrics["mean_return"]).tolist(),
        "first_update_vs_cpu": dev,
    }


def phase_gym_adapter(device, cpu, seed=0, out_dir=None):
    """One 24-step day through ``compat.gym_adapter.SmartNanogridEnv`` with
    the RBC policy; ``done`` must fire at t=23 and only there."""
    out_dir = out_dir or os.path.join(REPO, "nanogrid_outputs", "chip_smoke")
    with jax.enable_x64(False), jax.default_device(device):
        env = SmartNanogridEnv(
            number_of_chargers=8, pv_system_available_in_model=True,
            battery_system_available_in_model=True, time_interval="1h",
            vehicle_uncharged_penalty_mode="sparse", output_directory=out_dir, seed=seed)
        rbc = make_rbc_policy_fn(env.config)
        t0 = time.perf_counter()
        obs, _ = env.reset()
        obs, reward, done, _, _ = env.step(np.asarray(rbc(jnp.asarray(obs))))
        first_s = time.perf_counter() - t0
        rewards, dones = [reward], [done]
        t0 = time.perf_counter()
        for _ in range(env.config.steps_per_day - 1):
            obs, reward, done, _, _ = env.step(np.asarray(rbc(jnp.asarray(obs))))
            rewards.append(reward)
            dones.append(done)
        steady = (time.perf_counter() - t0) / (env.config.steps_per_day - 1)
    if dones != [False] * (len(dones) - 1) + [True]:
        raise AssertionError(f"gym adapter: done flags {dones}")
    if obs.shape != (env.config.obs_dim,):
        raise AssertionError(f"gym adapter: obs shape {obs.shape}")
    check_finite("gym adapter", (np.asarray(rewards), obs))
    return {"phase": "gym_adapter", "envs": 1, "first_step_s": first_s,
            "env_steps_per_s": 1.0 / steady, "peak_bytes_in_use": peak_bytes(device),
            "day_return": float(np.sum(rewards))}


def phase_at_scale(device, cpu, seed=0, batch=BATCH, days=3, config=None):
    """``evaluate_policy_at_scale`` with a PPO actor, against the same call on
    ``cpu``."""
    config = config or reference_config()
    with jax.enable_x64(False):
        params = make_params(config, dtype=jnp.float32)
        net = ActorCritic(action_dim=config.num_actions)
        net_params = net.init(jax.random.PRNGKey(seed + 3), jnp.zeros((1, config.obs_dim)))
        run = functools.partial(evaluate_policy_at_scale, config, num_days=days,
                                batch=batch, seed=seed, algorithm="ppo")
        with jax.default_device(device):
            t0 = time.perf_counter()
            run(params, net_params)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = run(params, net_params)
            steady = time.perf_counter() - t0
        with jax.default_device(cpu):
            ref = run(*jax.device_put((params, net_params), cpu))
    dev = {k: rel_diff(got[k], ref[k]) for k in ("mean_day_return", "std_day_return")}
    if got["total_days"] != days * batch or max(dev.values()) > AT_SCALE_RTOL:
        raise AssertionError(f"at-scale evaluation off the CPU run: {got} vs {ref}")
    return {"phase": "at_scale", "envs": batch, "days": days,
            "compile_s": first_s - steady,
            "env_steps_per_s": days * batch * config.steps_per_day / steady,
            "peak_bytes_in_use": peak_bytes(device), "result": got,
            "rel_vs_cpu": dev, "tol": AT_SCALE_RTOL}


PHASES = (phase_rbc_rollout, phase_policy_rollout, phase_ppo, phase_ddpg,
          phase_gym_adapter, phase_at_scale)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def check_sharded(tree, devices):
    """Every leaf is split over all ``devices`` along its leading env axis."""
    for leaf in jax.tree.leaves(tree):
        shards = leaf.addressable_shards
        if ({s.device for s in shards} != set(devices)
                or any(s.data.shape[0] * len(devices) != leaf.shape[0] for s in shards)):
            raise AssertionError(
                f"leaf {leaf.shape} not split over {devices}: "
                f"{[(s.device, s.data.shape) for s in shards]}")


def check_replicated(tree, devices):
    for leaf in jax.tree.leaves(tree):
        shards = leaf.addressable_shards
        if ({s.device for s in shards} != set(devices)
                or any(s.data.shape != leaf.shape for s in shards)):
            raise AssertionError(f"leaf {leaf.shape} not replicated over {devices}")


def phase_four_cards(devices, seed=0, batch_per_card=BATCH, config=None, ppo=None):
    """One PPO update with the env batch sharded over ``devices`` (a flat 1-D
    ``envs`` mesh), against the same global batch on ``devices[0]`` twice:
    the learner's own per-shard body with every shard vmapped over the
    ``envs`` axis name (:func:`vmapped_shard_map`; the same program, so the
    same update to rounding), and the unsharded ``PPOLearner`` (same days and
    noise, minibatches not stratified by shard)."""
    from __graft_entry__ import _assert_learner_reductions_only

    config = config or reference_config()
    n = len(devices)
    with jax.enable_x64(False):
        learner = PPOLearner(config, ppo or PPOConfig(), mesh=make_mesh(devices))
        state0 = learner.init_distributed(
            jax.random.PRNGKey(seed), make_params(config, dtype=jnp.float32),
            global_batch=n * batch_per_card, seed=seed)
        env_params = learner.nanogrid_params_batched
        check_sharded((state0.env_states, state0.last_obs, env_params), devices)
        check_replicated(state0.params, devices)
        compiled, (state1, metrics), compile_s, per_call = compile_and_time(
            learner.build_train_step(), (state0, env_params))
        _assert_learner_reductions_only(compiled.as_text(), "ppo_train_step", n)
        check_sharded((state1.env_states, state1.last_obs), devices)
        check_replicated((state1.params, state1.opt_state), devices)
        check_finite("four-card ppo", (state1.params, metrics))

        one_card_args = jax.device_put((state0, env_params), devices[0])
        with mock.patch.object(jax, "shard_map", vmapped_shard_map):
            one_card = jax.jit(learner._make_train_step_body())
            ref_state1, ref_metrics = one_card(*one_card_args)
        unsharded = PPOLearner(config, ppo or PPOConfig()).build_train_step()
        u_state1, u_metrics = unsharded(*one_card_args)
    envs_per_minibatch = n * batch_per_card // learner.ppo.num_minibatches
    devs = {}
    for name, (ref1, ref_m), update_tol in (
            ("vs_one_card", (ref_state1, ref_metrics), SHARDED_UPDATE_REL_TOL),
            ("vs_unsharded_learner", (u_state1, u_metrics),
             unsharded_update_rel_tol(envs_per_minibatch))):
        dev = {"params": update_deviation(state1.params, ref1.params, state0.params),
               "mean_return_rel": rel_diff(metrics.mean_return, ref_m.mean_return),
               "tol": {"rel_to_update": update_tol, "mean_return_rel": SHARDED_RETURN_RTOL}}
        if (dev["params"]["rel_to_update"] > update_tol
                or dev["mean_return_rel"] > SHARDED_RETURN_RTOL):
            raise AssertionError(f"sharded update off the one-card run ({name}): {dev}")
        devs[name] = dev
    return {
        "phase": "four_cards_ppo", "cards": n, "envs": n * batch_per_card,
        "compile_s": compile_s,
        "env_steps_per_s": n * batch_per_card * config.steps_per_day / per_call,
        "peak_bytes_in_use": [peak_bytes(d) for d in devices],
        "collectives": "all-reduce only",
        **devs,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the env-sharded PPO update on four cards and "
                        "its one-card comparison")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    devices = gpu_devices()
    enable_compile_cache()
    print(card_line(), flush=True)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"chip_smoke: --four-cards needs four GPUs, found {len(devices)}")
        runs = [functools.partial(phase_four_cards, devices[:4], args.seed)]
    else:
        cpu = jax.devices("cpu")[0]
        runs = [functools.partial(phase, devices[0], cpu, args.seed) for phase in PHASES]
    for run in runs:
        print(json.dumps(run()), flush=True)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
