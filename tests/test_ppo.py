"""PPO learner tests: single-device and sharded-mesh training steps run, metrics
are finite, mesh and single-device learners agree on the compiled math, and a
short training run improves the policy over random on the dense-penalty config.
"""

import numpy as np
import jax
import jax.numpy as jnp

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params
from smart_nanogrid_gym_tpu.parallel.mesh import make_mesh
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig, PPOLearner


ENV_CFG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)


def test_single_device_train_step():
    learner = PPOLearner(ENV_CFG, PPOConfig(num_epochs=2, num_minibatches=2))
    params = make_params(ENV_CFG, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(0), params, batch_size=32)
    state, history = learner.train(state, 2, log_every=1)
    assert int(state.update_step) == 2
    for m in history:
        assert np.isfinite(list(m)).all(), m


def test_sharded_train_step_runs_and_syncs():
    mesh = make_mesh(jax.devices("cpu"))
    learner = PPOLearner(ENV_CFG, PPOConfig(num_epochs=2, num_minibatches=2), mesh=mesh)
    params = make_params(ENV_CFG, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(0), params, batch_size=64)
    step_fn = learner.build_train_step()
    state2, metrics = step_fn(state, learner.nanogrid_params_batched)
    assert np.isfinite(float(metrics.mean_return))
    assert np.isfinite(float(metrics.policy_loss))
    # params stay replicated (identical across devices)
    leaves = jax.tree.leaves(state2.params)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    # gradient sync: all-reduce must appear in the compiled program
    hlo = step_fn.lower(state, learner.nanogrid_params_batched).compile().as_text()
    assert "all-reduce" in hlo


def test_train_many_matches_sequential_steps():
    """build_train_many's scanned body is the exact single-step body: N
    scanned updates from a state must equal N sequential train_step calls
    bitwise (same RNG flow through state.key) — so the amortized benchmark
    path measures the same program the step-by-step trainer runs."""
    learner = PPOLearner(ENV_CFG, PPOConfig(num_epochs=2, num_minibatches=2))
    params = make_params(ENV_CFG, dtype=jnp.float32)
    state0 = learner.init(jax.random.PRNGKey(3), params, batch_size=32)

    step_fn = learner.build_train_step()
    state_seq = state0
    for _ in range(3):
        state_seq, metrics_seq = step_fn(state_seq, learner.nanogrid_params_batched)

    many = learner.build_train_many(3)
    state_many, metrics_many = many(state0, learner.nanogrid_params_batched)

    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        state_seq.params, state_many.params,
    )
    assert int(state_many.update_step) == 3
    # stacked metrics: last row equals the last sequential step's metrics
    np.testing.assert_array_equal(
        np.asarray(metrics_many.mean_return[-1]), np.asarray(metrics_seq.mean_return))


def test_training_improves_over_random():
    """A few updates on the dense-penalty config should beat the untrained
    policy (rewards are heavily shaped, so PPO picks up signal fast)."""
    cfg = NanogridConfig(
        num_chargers=4, pv_system=False, battery_system=False, penalty_mode="dense"
    )
    learner = PPOLearner(cfg, PPOConfig(num_epochs=4, num_minibatches=4, learning_rate=1e-3))
    params = make_params(cfg, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(1), params, batch_size=64)
    step_fn = learner.build_train_step()

    _, m0 = step_fn(state, learner.nanogrid_params_batched)
    for _ in range(15):
        state, metrics = step_fn(state, learner.nanogrid_params_batched)
    assert float(metrics.mean_return) > float(m0.mean_return), (
        float(m0.mean_return), float(metrics.mean_return),
    )


def test_bf16_update_sweep_trains():
    """update_matmul_dtype=bf16 (mixed precision: f32 master params, bf16
    matmul operands inside the loss) must keep params f32, metrics finite,
    and still learn."""
    cfg = NanogridConfig(
        num_chargers=4, pv_system=False, battery_system=False, penalty_mode="dense"
    )
    learner = PPOLearner(
        cfg, PPOConfig(num_epochs=4, learning_rate=1e-3,
                       update_matmul_dtype=jnp.bfloat16))
    params = make_params(cfg, dtype=jnp.float32)
    state = learner.init(jax.random.PRNGKey(1), params, batch_size=64)
    step_fn = learner.build_train_step()
    _, m0 = step_fn(state, learner.nanogrid_params_batched)
    for _ in range(15):
        state, metrics = step_fn(state, learner.nanogrid_params_batched)
    # master params stay full precision — no bf16 leaks out of the loss
    assert all(x.dtype != jnp.bfloat16 for x in jax.tree.leaves(state.params))
    assert np.isfinite(list(metrics)).all()
    assert float(metrics.mean_return) > float(m0.mean_return)
