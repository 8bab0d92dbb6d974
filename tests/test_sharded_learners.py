"""Sharded learners on 4 virtual CPU devices against one device at the same
global batch — the CPU rehearsal of ``chip_smoke.py --four-cards``.

One one-device side runs the learner's own per-shard body with every shard
vmapped over the ``envs`` axis name (``chip_smoke.vmapped_shard_map``), so it
computes the same global update without a mesh.  The other is the unsharded
learner: it simulates the same days with the same noise, and differs only
where the docstrings say (per-shard minibatch strata and replay sampling).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from smart_nanogrid_gym_tpu.core import make_params
from smart_nanogrid_gym_tpu.parallel.mesh import make_mesh
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig, DDPGLearner
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner

DEVICES = jax.devices("cpu")[:4]


def test_sharded_ppo_matches_one_device():
    r = chip_smoke.phase_four_cards(DEVICES, batch_per_card=8,
                                    ppo=PPOConfig(num_epochs=2, num_minibatches=2))
    assert r["cards"] == 4 and r["envs"] == 32
    assert r["vs_one_card"]["params"]["rel_to_update"] <= chip_smoke.SHARDED_UPDATE_REL_TOL
    assert r["vs_unsharded_learner"]["params"]["rel_to_update"] \
        <= chip_smoke.unsharded_update_rel_tol(16)
    assert r["vs_unsharded_learner"]["mean_return_rel"] <= chip_smoke.SHARDED_RETURN_RTOL


def test_sharded_ddpg_matches_one_device():
    config = chip_smoke.reference_config()
    learner = DDPGLearner(config, DDPGConfig(buffer_days=2, gradient_steps=4, batch_size=32),
                          mesh=make_mesh(DEVICES))
    with jax.enable_x64(False):
        state0 = learner.init(jax.random.PRNGKey(2), make_params(config, dtype=jnp.float32), 32)
        env_params = learner.nanogrid_params_batched
        state1, metrics = learner.build_train_step()(state0, env_params)
        with mock.patch.object(jax, "shard_map", chip_smoke.vmapped_shard_map):
            one_device = jax.jit(learner._make_body())
        ref1, ref_metrics = one_device(*jax.device_put((state0, env_params), DEVICES[0]))

    assert len(state1.env_states.batt_soc.sharding.device_set) == 4
    params = lambda s: (s.actor_params, s.critic_params)
    dev = chip_smoke.update_deviation(params(state1), params(ref1), params(state0))
    assert dev["rel_to_update"] <= chip_smoke.SHARDED_UPDATE_REL_TOL, dev
    assert chip_smoke.rel_diff(metrics["mean_return"], ref_metrics["mean_return"]) \
        <= chip_smoke.SHARDED_RETURN_RTOL
    np.testing.assert_array_equal(np.asarray(state1.buffer.rewards), np.asarray(ref1.buffer.rewards))


def test_sharded_ppo_simulates_the_unsharded_days():
    """Two updates: the sharded learner's envs see the unsharded learner's
    days, and the first update — before the params part — the same returns."""
    config = chip_smoke.reference_config()
    ppo = PPOConfig(num_epochs=2, num_minibatches=2)
    with jax.enable_x64(False):
        sharded = PPOLearner(config, ppo, mesh=make_mesh(DEVICES))
        state0 = sharded.init(jax.random.PRNGKey(4), make_params(config, dtype=jnp.float32), 32)
        env_params = sharded.nanogrid_params_batched
        s2, m2 = sharded.build_train_many(2)(state0, env_params)
        u2, um2 = PPOLearner(config, ppo).build_train_many(2)(
            *jax.device_put((state0, env_params), DEVICES[0]))

    assert len(s2.env_states.batt_soc.sharding.device_set) == 4
    assert chip_smoke.rel_diff(m2.mean_return[0], um2.mean_return[0]) <= chip_smoke.SHARDED_RETURN_RTOL
    for got, want in zip(jax.tree.leaves((s2.env_states.schedule, s2.env_states.pv_shift)),
                         jax.tree.leaves((u2.env_states.schedule, u2.env_states.pv_shift))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_ddpg_collects_the_unsharded_days():
    """One update: the sharded replay buffer holds the unsharded learner's
    transitions (same days, same OU noise); only replay sampling is per shard."""
    config = chip_smoke.reference_config()
    ddpg = DDPGConfig(buffer_days=2, gradient_steps=4, batch_size=32)
    with jax.enable_x64(False):
        sharded = DDPGLearner(config, ddpg, mesh=make_mesh(DEVICES))
        state0 = sharded.init(jax.random.PRNGKey(5), make_params(config, dtype=jnp.float32), 32)
        env_params = sharded.nanogrid_params_batched
        state1, metrics = sharded.build_train_step()(state0, env_params)
        unsharded = DDPGLearner(config, ddpg)
        unsharded.init(jax.random.PRNGKey(5), make_params(config, dtype=jnp.float32), 32)
        u1, u_metrics = unsharded.build_train_step()(*jax.device_put((state0, env_params), DEVICES[0]))

    for field in ("obs", "actions", "rewards", "next_obs"):
        np.testing.assert_allclose(np.asarray(getattr(state1.buffer, field)),
                                   np.asarray(getattr(u1.buffer, field)), rtol=1e-5, atol=1e-6)
    assert chip_smoke.rel_diff(metrics["mean_return"], u_metrics["mean_return"]) \
        <= chip_smoke.SHARDED_RETURN_RTOL
