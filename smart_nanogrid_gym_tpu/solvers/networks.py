"""Policy/value networks in plain JAX.

Architectures mirror the SB3 defaults the reference trains with so rewards are
comparable run-for-run:

- PPO "MlpPolicy": separate 64-64 tanh MLPs for policy mean and value, with a
  state-independent log-std (reference solvers/RL/ppo_train.py:92 uses SB3
  defaults).
- DDPG "MlpPolicy": 400-300 ReLU actor (tanh-squashed to the action space) and
  Q-network (reference solvers/RL/ddpg_train.py:109-113 uses SB3 defaults).

Each module is a frozen dataclass with ``.init(key, *inputs) -> params`` and
``.apply(params, *inputs)``.  The param tree is
``{"params": {<name>: {"Dense_i": {"kernel" (in, out), "bias"}}, ["log_std"]}}``
— the layout of the committed checkpoints (``artifacts/``) and of
:mod:`..compat.sb3_loader`.  Hidden layers use orthogonal init with gain √2,
output layers gain 0.01 (PPO policy head) or 1.0, biases zero.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

_HIDDEN_GAIN = float(np.sqrt(2))


def _mlp_init(key, n_in: int, hidden: Sequence[int], n_out: int, out_gain: float) -> dict:
    sizes = (n_in,) + tuple(hidden) + (n_out,)
    gains = (_HIDDEN_GAIN,) * len(hidden) + (out_gain,)
    keys = jax.random.split(key, len(gains))
    return {
        f"Dense_{i}": {
            "kernel": jax.nn.initializers.orthogonal(gain)(
                keys[i], (sizes[i], sizes[i + 1]), jnp.float32),
            "bias": jnp.zeros((sizes[i + 1],), jnp.float32),
        }
        for i, gain in enumerate(gains)
    }


def _mlp_apply(layers: dict, x, activation: Callable):
    n = len(layers)
    for i in range(n):
        layer = layers[f"Dense_{i}"]
        x = x @ layer["kernel"] + layer["bias"]
        if i < n - 1:
            x = activation(x)
    return x


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """PPO actor-critic with SB3-default torso sizes: ``apply(params, obs) ->
    (mean, log_std, value)``."""

    action_dim: int
    hidden: Sequence[int] = (64, 64)

    def init(self, key, obs) -> dict:
        k_pi, k_vf = jax.random.split(key)
        n_in = obs.shape[-1]
        return {"params": {
            "pi": _mlp_init(k_pi, n_in, self.hidden, self.action_dim, 0.01),
            "log_std": jnp.zeros((self.action_dim,), jnp.float32),
            "vf": _mlp_init(k_vf, n_in, self.hidden, 1, 1.0),
        }}

    def apply(self, params: dict, obs):
        p = params["params"]
        mean = _mlp_apply(p["pi"], obs, jnp.tanh)
        value = _mlp_apply(p["vf"], obs, jnp.tanh)
        return mean, p["log_std"], jnp.squeeze(value, axis=-1)


@dataclasses.dataclass(frozen=True)
class DDPGActor:
    """DDPG actor: tanh output scaled/shifted into the env's action box."""

    action_dim: int
    action_low: tuple
    action_high: tuple
    hidden: Sequence[int] = (400, 300)

    def init(self, key, obs) -> dict:
        return {"params": {
            "mu": _mlp_init(key, obs.shape[-1], self.hidden, self.action_dim, 1.0)}}

    def apply(self, params: dict, obs):
        squashed = jnp.tanh(_mlp_apply(params["params"]["mu"], obs, jax.nn.relu))
        low = jnp.asarray(self.action_low, squashed.dtype)
        high = jnp.asarray(self.action_high, squashed.dtype)
        return low + (squashed + 1.0) * 0.5 * (high - low)


@dataclasses.dataclass(frozen=True)
class DDPGCritic:
    """DDPG Q-network over the concatenated ``(obs, action)``."""

    hidden: Sequence[int] = (400, 300)

    def init(self, key, obs, action) -> dict:
        n_in = obs.shape[-1] + action.shape[-1]
        return {"params": {"q": _mlp_init(key, n_in, self.hidden, 1, 1.0)}}

    def apply(self, params: dict, obs, action):
        x = jnp.concatenate([obs, action], axis=-1)
        return jnp.squeeze(_mlp_apply(params["params"]["q"], x, jax.nn.relu), axis=-1)
