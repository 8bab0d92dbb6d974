"""Device-mesh sharding of env batches.

The reference has no parallel execution of any kind (SURVEY.md §2.3) — one env
object stepped by a single Python loop.  The scaling model here:

- envs are embarrassingly parallel; the env batch is sharded over a 1-D
  ``envs`` mesh axis (multi-host: the same axis spans hosts — each host
  generates/owns its shard, BASELINE config 5),
- the rolled-out step function contains **no collectives**; cross-device
  communication appears only in the learner (gradient ``psum`` over the same
  axis, :mod:`..solvers.ppo`),
- sharding is expressed with ``NamedSharding`` + ``shard_map`` so XLA lays the
  batch out once and every step stays device-resident.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout

ENV_AXIS = "envs"


def make_mesh(devices=None, axis_name: str = ENV_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_env_batch(tree, mesh: Mesh, axis_name: str = ENV_AXIS):
    """Place a batched pytree with its leading env axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def sharded_rollout_fn(
    config: NanogridConfig,
    mesh: Mesh,
    policy_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    num_steps: int | None = None,
    axis_name: str = ENV_AXIS,
):
    """Build a jitted, shard_map-ped closed-loop rollout over the env batch.

    Returns ``rollout(params, states, obs, keys) -> (states', obs', (obs, rew,
    done))`` where every argument/result has a leading env axis sharded over
    ``mesh``.  The body is per-shard pure vmapped stepping — XLA inserts no
    collectives (verified by test_parallel.py), so scaling is linear.
    """
    num_days = max(1, (num_steps or config.steps_per_day) // config.steps_per_day)

    def shard_body(params, states, obs, keys):
        # keys: (num_days,) day keys (replicated); one fused day scan per day.
        # Chained days pass the previous trailing obs (continuation invariant).
        trajs = []
        obs0 = obs
        for d in range(num_days):
            states, traj = fused_day_rollout(
                config, params, states, policy_fn, keys[d], obs0=obs0
            )
            obs0 = traj[0][-1]
            trajs.append(traj)
        obs_traj, rewards, dones = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *trajs
        )
        return states, obs_traj[-1], (obs_traj, rewards, dones)

    spec = P(axis_name)
    traj_spec = P(None, axis_name)  # trajectories have a leading time axis
    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(spec, spec, spec, P()),  # keys are per-step, replicated
        out_specs=(spec, spec, (traj_spec, traj_spec, traj_spec)),
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_block(x, mesh: Mesh | None, axis: int = 0, axis_name: str = ENV_AXIS):
    """This shard's block of ``x``, an array laid out over the *global* env
    batch along ``axis``, inside a ``shard_map`` body over ``mesh``; ``x``
    itself without a mesh.  Learners draw per-env randomness for the global
    batch and take their block, so a mesh changes no env's random stream."""
    if mesh is None:
        return x
    size = x.shape[axis] // mesh.shape[axis_name]
    return jax.lax.dynamic_slice_in_dim(
        x, jax.lax.axis_index(axis_name) * size, size, axis)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree over the mesh (e.g. learner params)."""
    return jax.device_put(tree, NamedSharding(mesh, P()))
