"""Multi-host distributed runtime (BASELINE config 5 / north-star scaling).

The reference is strictly single-process (SURVEY.md §2.3: no multiprocessing,
no vectorized envs, no collectives of any kind).  The scaling model spans the
devices of one or more hosts:

- **process wiring**: :func:`initialize_distributed` wraps
  ``jax.distributed.initialize`` with env-var autodetection (a no-op for
  single-process runs, so every entry point can call it unconditionally);
- **one global mesh**: a 1-D ``envs`` axis over every device of every host —
  the env batch is embarrassingly parallel, so the rollout needs *zero*
  collectives and scaling is linear by construction (the learner's
  gradient ``psum`` is the only cross-device traffic in the framework);
- **host-local day generation**: each process generates/owns only its shard of
  the global env batch.  Keys are derived from *global* env indices
  (fold_in(seed, global_index)), so the generated days are bit-identical no
  matter how many hosts participate — a 1-host run and a 4-host run simulate
  the same days;
- **global arrays from local shards**: per-host data becomes one global jax
  Array assembled from explicit per-device shards (:func:`make_global_array`)
  — jit then consumes the global array directly and XLA keeps every shard
  device-resident.

Scaling efficiency is measured by :func:`scaling_sweep` (also exposed as
``bench.py --scaling``): fixed per-device env batch, mesh sizes 1..N, steps/s
and efficiency vs linear.  tests/test_distributed.py additionally pins that
the *compiled per-device cost* of the sharded rollout is mesh-size-invariant,
which is the compile-time form of the ≥80% scaling north star (BASELINE.md:17).
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.transition import reset as core_reset
from .mesh import ENV_AXIS, make_mesh, sharded_rollout_fn


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> tuple[int, int]:
    """Wire up ``jax.distributed`` for multi-host runs; single-process no-op.

    Arguments fall back to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).
    Returns ``(process_index, process_count)``.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_num = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_num is not None:
        num_processes = int(env_num)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)

    # Detect a prior jax.distributed.initialize WITHOUT touching the XLA
    # backend: jax.process_count() would itself initialise backends, after
    # which jax.distributed.initialize raises ("must be called before any JAX
    # computations are executed").  The distributed client handle is the one
    # signal that exists pre-backend.
    from jax._src import distributed as _jax_distributed

    already = _jax_distributed.global_state.client is not None
    if coordinator_address and not already:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def global_env_mesh(devices=None, axis_name: str = ENV_AXIS) -> Mesh:
    """1-D env mesh over every device of every participating host."""
    return make_mesh(devices, axis_name)


def host_shard_bounds(
    mesh: Mesh, global_batch: int, axis_name: str = ENV_AXIS
) -> tuple[int, int]:
    """This process's contiguous [lo, hi) slice of the global env axis.

    Derived from the sharding's device→index map restricted to addressable
    devices, so it is correct for any process→device enumeration.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    index_map = sharding.addressable_devices_indices_map((global_batch,))
    starts, stops = [], []
    for (sl,) in index_map.values():
        starts.append(0 if sl.start is None else sl.start)
        stops.append(global_batch if sl.stop is None else sl.stop)
    lo, hi = min(starts), max(stops)
    # Contiguity holds for a 1-D mesh built from the default device order;
    # guard it so a future exotic layout fails loudly rather than silently
    # generating the wrong envs.
    span = sorted((a, b) for a, b in zip(starts, stops))
    covered = span[0][0]
    for a, b in span:
        if a > covered:  # correctness guard — must survive python -O
            raise RuntimeError(f"non-contiguous host shard: {span}")
        covered = max(covered, b)
    return lo, hi


def make_global_array(tree, mesh: Mesh, global_batch: int, axis_name: str = ENV_AXIS):
    """Assemble per-host local shards (leading axis = local batch) into global
    jax Arrays sharded over the env axis.

    Built from explicit per-device shards (``make_array_from_single_device_
    arrays``), so the assembly uses exactly the mesh's own devices whatever
    the default backend is."""
    sharding = NamedSharding(mesh, P(axis_name))
    lo, _ = host_shard_bounds(mesh, global_batch, axis_name)

    def leaf(x):
        x = np.asarray(x)
        gshape = (global_batch,) + x.shape[1:]
        shards = []
        for d, idx in sharding.addressable_devices_indices_map(gshape).items():
            sl = idx[0]
            start = (sl.start or 0) - lo
            stop = (global_batch if sl.stop is None else sl.stop) - lo
            shards.append(jax.device_put(x[start:stop], d))
        return jax.make_array_from_single_device_arrays(gshape, sharding, shards)

    return jax.tree.map(leaf, tree)


def replicate_global(tree, mesh: Mesh):
    """Replicate host-local values over a (possibly multi-host) mesh via
    explicit per-device copies — works when the mesh spans non-addressable
    devices; every process must pass the same values (true for learner params
    initialised from a shared seed)."""
    repl = NamedSharding(mesh, P())

    def leaf(x):
        x = np.asarray(x)
        shards = [
            jax.device_put(x, d)
            for d in repl.addressable_devices_indices_map(x.shape).keys()
        ]
        return jax.make_array_from_single_device_arrays(x.shape, repl, shards)

    return jax.tree.map(leaf, tree)


def global_env_keys(seed: int, lo: int, hi: int) -> jnp.ndarray:
    """Per-env PRNG keys for global indices [lo, hi): fold_in of the *global*
    env index, so schedules are identical under any process count."""
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(lo, hi))


def distributed_reset(
    config: NanogridConfig,
    params: NanogridParams,
    mesh: Mesh,
    global_batch: int,
    seed: int = 0,
    axis_name: str = ENV_AXIS,
):
    """Host-local day generation + global sharded env state.

    Each process generates only its own [lo, hi) shard of the env batch (keys
    from global indices — process-count-invariant schedules) and the shards
    are assembled into global arrays over the mesh.  Returns
    ``(bparams, states, obs)``, all globally sharded / replicated as jit
    expects them.
    """
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by mesh size {mesh.size}")
    lo, hi = host_shard_bounds(mesh, global_batch, axis_name)
    local = hi - lo
    local_params = jax.tree.map(lambda x: jnp.broadcast_to(x, (local,) + x.shape), params)
    keys = global_env_keys(seed, lo, hi)
    states, obs = jax.jit(jax.vmap(functools.partial(core_reset, config)))(
        local_params, keys, None, None
    )
    states = make_global_array(states, mesh, global_batch, axis_name)
    obs = make_global_array(obs, mesh, global_batch, axis_name)
    bparams = make_global_array(local_params, mesh, global_batch, axis_name)
    return bparams, states, obs


# ---------------------------------------------------------------------------
# scaling-efficiency benchmark
# ---------------------------------------------------------------------------


def _default_policy(config: NanogridConfig) -> Callable:
    from ..solvers.rbc import rbc_policy

    policy = jax.vmap(functools.partial(rbc_policy, config))
    return lambda obs, key: policy(obs)


def scaling_sweep(
    config: NanogridConfig,
    params: NanogridParams,
    devices=None,
    batch_per_device: int = 512,
    num_days: int = 20,
    timed_calls: int = 3,
    mesh_sizes=None,
) -> list[dict]:
    """Measure closed-loop RBC rollout throughput vs mesh size (fixed
    per-device batch — weak scaling, the deployment regime) and report
    efficiency vs linear extrapolation of the smallest mesh's number.

    Each device runs the fused XLA day rollout on its env shard
    (:func:`.mesh.sharded_rollout_fn`, zero collectives).  Returns one record
    per mesh size: ``{"devices", "global_batch", "steps_per_sec",
    "efficiency"}``.
    """
    devices = list(devices if devices is not None else jax.devices())
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
        if len(devices) not in mesh_sizes:
            mesh_sizes.append(len(devices))

    steps_per_day = config.steps_per_day
    results = []
    base_rate = None
    for n in mesh_sizes:
        mesh = Mesh(np.asarray(devices[:n]), (ENV_AXIS,))
        global_batch = batch_per_device * n
        bparams, states, obs = distributed_reset(config, params, mesh, global_batch)
        rollout = sharded_rollout_fn(
            config, mesh, _default_policy(config), num_steps=num_days * steps_per_day
        )
        day_keys = jax.random.split(jax.random.PRNGKey(1), num_days)

        jax.block_until_ready(rollout(bparams, states, obs, day_keys))  # compile + warm-up
        t0 = time.perf_counter()
        for _ in range(timed_calls):
            jax.block_until_ready(rollout(bparams, states, obs, day_keys))
        dt = time.perf_counter() - t0

        rate = global_batch * steps_per_day * num_days * timed_calls / dt
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": n,
                "global_batch": global_batch,
                "steps_per_sec": rate,
                "efficiency": rate / (base_rate * n / mesh_sizes[0]),
            }
        )
    return results


def write_scaling_report(results: list[dict], path: str, meta: dict | None = None) -> None:
    payload = {"records": results}
    if meta:
        payload.update(meta)
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=2)
