"""Multi-process distributed worker — a runnable multi-host demonstration.

The multi-host path (BASELINE config 5) is demonstrated with REAL separate
processes over the CPU backend: N
OS processes × 4 virtual devices each, wired by ``jax.distributed`` with gloo
collectives standing in for the inter-host network.  Everything else is exactly the production
path: host-local env-shard generation (global-index keys), a global 1-D env
mesh spanning all processes, the zero-collective sharded rollout, and the
sharded PPO train step whose gradient ``psum`` crosses processes.

Launch one worker per "host" (any order; they rendezvous at the coordinator):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
    python -m smart_nanogrid_gym_tpu.parallel.multihost_demo \\
        --process-id 0 --num-processes 2 --coordinator localhost:12355
    ... (same with --process-id 1)

Each worker prints ONE JSON line: rollout mean day return over the global
batch, PPO train-step mean return, process/device counts.  The values are
identical on every process (global arrays + replicated learner) and identical
to a single-process run of the same global batch — the process-count-
invariance contract tests/test_multihost.py pins.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--coordinator", default="localhost:12355")
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--train-batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if args.num_processes > 1:
        # Goes through the production wrapper (not a direct
        # jax.distributed.initialize) so the multi-process tests exercise the
        # same init path train_ppo --distributed uses.
        from .distributed import initialize_distributed

        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ..core import NanogridConfig, make_params
    from ..solvers.ppo import PPOConfig, PPOLearner
    from . import distributed as D
    from .mesh import ENV_AXIS, sharded_rollout_fn

    devices = jax.devices("cpu")
    mesh = Mesh(np.asarray(devices), (ENV_AXIS,))

    config = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    params = make_params(config, dtype=jnp.float32)

    # host-local generation -> global sharded arrays -> zero-collective rollout
    bparams, states, obs = D.distributed_reset(
        config, params, mesh, args.global_batch, seed=args.seed
    )
    rollout = sharded_rollout_fn(config, mesh, D._default_policy(config))
    keys = jax.random.split(jax.random.PRNGKey(1), 1)
    _, _, (_, rewards, _) = rollout(bparams, states, obs, keys)
    from jax.experimental import multihost_utils

    day_returns = multihost_utils.process_allgather(rewards.sum(axis=0), tiled=True)
    rollout_mean = float(np.asarray(day_returns).mean())

    # distributed PPO: replicated learner, sharded envs, cross-process psum
    learner = PPOLearner(config, PPOConfig(num_epochs=1, num_minibatches=2), mesh=mesh)
    state = learner.init_distributed(
        jax.random.PRNGKey(0), params, global_batch=args.train_batch
    )
    train_step = learner.build_train_step()
    state, metrics = train_step(state, learner.nanogrid_params_batched)
    jax.block_until_ready(state)

    print(json.dumps({
        "process": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": len(devices),
        "local_devices": len(jax.local_devices(backend="cpu")),
        "rollout_mean_day_return": round(rollout_mean, 6),
        "ppo_mean_return": round(float(metrics.mean_return), 6),
    }), flush=True)


if __name__ == "__main__":
    main()
