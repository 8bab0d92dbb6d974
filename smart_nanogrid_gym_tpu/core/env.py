"""Batched environment engine: the user-facing functional API.

``SmartNanogridTPU`` bundles a static :class:`NanogridConfig` with jitted,
vmapped entry points.  The per-env transition lives in :mod:`.step`; this module
adds the batch axis (``vmap``), full-day rollouts (``lax.scan``), and
policy-in-the-loop closed-loop rollouts — everything stays on device.

Replaces the reference's single-object Gym env + SB3 outer Python loop
(solvers/RL/ppo_train.py:94-102 drives 1.02M sequential env.step calls; here a
single device call advances ``batch × steps_per_day`` env-steps).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from .config import NanogridConfig
from .params import NanogridParams, make_params
from .rollout import fused_day_rollout
from .state import DaySchedule, EnvState
from .transition import StepResult, observe, reset, step


class SmartNanogridTPU:
    """Batched smart-nanogrid environment engine.

    All methods are pure functions of ``(params, state, ...)``; the instance
    holds only the static config and cached jitted callables.

    ``batched=True`` methods expect a leading env axis on ``params`` *and*
    ``state`` (heterogeneous batches vary ``params`` per env; homogeneous
    batches can broadcast the same params via ``jax.tree.map``).
    """

    def __init__(self, config: NanogridConfig | None = None, **kwargs):
        self.config = config or NanogridConfig(**kwargs)

        cfg = self.config
        self._reset = jax.jit(functools.partial(reset, cfg))
        self._step = jax.jit(functools.partial(step, cfg))
        self._observe = jax.jit(functools.partial(observe, cfg))
        self._reset_batch = jax.jit(jax.vmap(functools.partial(reset, cfg)))
        self._step_batch = jax.jit(jax.vmap(functools.partial(step, cfg)))

    # ---- params / state construction ---------------------------------------

    def default_params(self, dtype=jnp.float32) -> NanogridParams:
        return make_params(self.config, dtype=dtype)

    def broadcast_params(self, params: NanogridParams, batch: int) -> NanogridParams:
        """Tile identical params along a new leading env axis."""
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), params)

    # ---- single env ---------------------------------------------------------

    def reset(self, params, key, batt_soc=None, schedule=None):
        return self._reset(params, key, batt_soc, schedule)

    def step(self, params, state, action) -> StepResult:
        return self._step(params, state, action)

    def observe(self, params, state):
        return self._observe(params, state)

    # ---- batched ------------------------------------------------------------

    def reset_batch(self, params, keys):
        """Reset a batch: ``params`` has a leading env axis, ``keys`` is (B, 2)."""
        return self._reset_batch(params, keys, None, None)

    def step_batch(self, params, states, actions) -> StepResult:
        return self._step_batch(params, states, actions)

    # ---- on-device rollouts --------------------------------------------------

    def rollout_day(
        self,
        params: NanogridParams,
        state: EnvState,
        policy_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
        obs: jnp.ndarray,
        batched: bool = True,
        key: jnp.ndarray | None = None,
    ):
        """Roll exactly one day via the fused time-major scan
        (:func:`..core.rollout.fused_day_rollout`).

        ``policy_fn(obs, key) -> actions``.  Days are fixed-length, so rollouts
        never need data-dependent resets (``done`` always fires at step T-1 —
        envs/smart_nanogrid_environment.py:233-237).  ``state.t`` must be 0.

        Returns ``(final_state, final_obs, (obs, reward, done, info))`` with
        trajectory leaves stacked along a leading time axis.
        """
        cfg = self.config
        if not batched:
            params = jax.tree.map(lambda x: x[None], params)
            state = jax.tree.map(lambda x: x[None], state)
            obs = obs[None]
        final_state, (obs_traj, rewards, dones, infos) = fused_day_rollout(
            cfg, params, state, policy_fn, key if key is not None else jax.random.PRNGKey(0),
            collect_info=True, obs0=obs,
        )
        if not batched:
            final_state = jax.tree.map(lambda x: x[0], final_state)
            obs_traj, rewards, dones, infos = jax.tree.map(
                lambda x: x[:, 0], (obs_traj, rewards, dones, infos)
            )
        return final_state, obs_traj[-1], (obs_traj, rewards, dones, infos)

    def rollout_actions(self, params, state, actions, batched: bool = True):
        """Roll a precomputed action sequence ``(T, ...)`` through ``lax.scan``."""
        cfg = self.config
        step_fn = jax.vmap(functools.partial(step, cfg)) if batched else functools.partial(step, cfg)

        def body(st, a_t):
            res = step_fn(params, st, a_t)
            return res.state, (res.obs, res.reward, res.done, res.info)

        final_state, traj = jax.lax.scan(body, state, actions)
        return final_state, traj
