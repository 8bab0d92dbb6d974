"""Vectorized Gymnasium adapter backed by the batched device engine.

The reference has no vectorized execution at all (SB3 drives one raw env,
solvers/RL/ppo_train.py:89-92).  This adapter exposes the batched engine
through the ``gymnasium.vector.VectorEnv`` interface so existing vector-API
training code (SB3 VecEnv-style loops, cleanrl, etc.) can drive thousands of
envs with one device call per step.

Because days are fixed-length, every env finishes simultaneously; on ``done``
the adapter auto-resets the whole batch with freshly generated days (standard
vector-env autoreset semantics — the reset observation is returned at the next
step, with ``final_observation`` in infos).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium
    from gymnasium import spaces as gym_spaces

    _VECTOR_BASE = gymnasium.vector.VectorEnv
except ImportError:  # pragma: no cover
    gymnasium = None
    gym_spaces = None
    _VECTOR_BASE = object

from ..core import NanogridConfig, make_params
from ..core.transition import reset as core_reset, step as core_step


class VectorSmartNanogridEnv(_VECTOR_BASE):
    """num_envs lockstep nanogrid environments on one device."""

    metadata = {"render_modes": []}

    def __init__(self, num_envs: int = 1024, seed: int = 0, dtype=jnp.float32, **reference_kwargs):
        self.config = NanogridConfig.from_reference_kwargs(**reference_kwargs)
        self.num_envs = num_envs
        params = make_params(self.config, dtype=dtype)
        self.params = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (num_envs,) + x.shape), params
        )
        self._key = jax.random.PRNGKey(seed)
        self._states = None

        self._jit_reset = jax.jit(jax.vmap(functools.partial(core_reset, self.config)))
        self._jit_step = jax.jit(jax.vmap(functools.partial(core_step, self.config)))

        if gym_spaces is not None:
            cfg = self.config
            obs_low = np.zeros(cfg.obs_dim, dtype=np.float32)
            obs_high = np.ones(cfg.obs_dim, dtype=np.float32)
            self.single_observation_space = gym_spaces.Box(obs_low, obs_high, dtype=np.float32)
            from .gym_adapter import SmartNanogridEnv

            _, self.single_action_space = SmartNanogridEnv._build_spaces(cfg)
            self.observation_space = gym_spaces.Box(
                np.tile(obs_low, (num_envs, 1)), np.tile(obs_high, (num_envs, 1)), dtype=np.float32
            )
            self.action_space = gym_spaces.Box(
                np.tile(self.single_action_space.low, (num_envs, 1)),
                np.tile(self.single_action_space.high, (num_envs, 1)),
                dtype=np.float32,
            )

    # -------------------------------------------------------------- VectorEnv --

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, self.num_envs)
        batt = None if self._states is None else self._states.batt_soc
        self._states, obs = self._jit_reset(self.params, keys, batt, None)
        return np.asarray(obs), {}

    def step(self, actions):
        actions = jnp.asarray(np.asarray(actions, dtype=np.float32))
        res = self._jit_step(self.params, self._states, actions)
        self._states = res.state
        obs = np.asarray(res.obs)
        rewards = np.asarray(res.reward)
        dones = np.asarray(res.done)
        infos = {}
        if dones.all():
            # synchronized day end: autoreset with fresh days
            infos["final_observation"] = obs
            obs, _ = self.reset()
        terminated = dones
        truncated = np.zeros_like(dones)
        return obs, rewards, terminated, truncated, infos

    def close(self):
        pass
