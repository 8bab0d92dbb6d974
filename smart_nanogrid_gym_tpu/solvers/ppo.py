"""Sharded on-device PPO (the BASELINE config-5 north-star learner).

The reference trains SB3 PPO against a single Python env — 1.02M sequential
``env.step`` calls per script run (solvers/RL/ppo_train.py:94-102).  Here the
whole actor-learner loop is one jitted, shard_map-ped device program
("Anakin"-style):

- every device rolls out its shard of the env batch for one day (24 steps)
  with the current policy (replicated params),
- GAE and the clipped PPO loss are computed on device,
- gradients are ``psum``-ed over the ``envs`` mesh axis — the only collective
  in the whole framework — and applied with optax.Adam,
- the outer Python loop only orchestrates update counts and metrics fetches.

Hyperparameters default to SB3's PPO defaults (lr 3e-4, γ 0.99, λ 0.95,
clip 0.2, 10 epochs, entropy 0.0, vf 0.5) for comparability with the
reference's training setup.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout
from ..core.transition import reset as core_reset
from ..parallel.mesh import ENV_AXIS, shard_block
from .networks import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 10
    num_minibatches: int = 4
    rollout_days: int = 1  # days of rollout per update (T = 24·days steps)
    # Matmul operand dtype for the update sweep's fwd/bwd passes (mixed
    # precision: master params, optimizer state, and all loss/advantage math
    # stay f32; only the network apply inside the loss casts params+inputs).
    # None/f32 = full precision.
    update_matmul_dtype: object | None = None


class PPOTrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    env_states: object       # batched EnvState (sharded)
    last_obs: jnp.ndarray    # (B, obs_dim) (sharded)
    key: jnp.ndarray
    update_step: jnp.ndarray


class PPOMetrics(NamedTuple):
    policy_loss: jnp.ndarray
    value_loss: jnp.ndarray
    entropy: jnp.ndarray
    approx_kl: jnp.ndarray
    mean_return: jnp.ndarray  # mean per-day return across the rollout batch


def _gaussian_logp(mean, log_std, action):
    var = jnp.exp(2 * log_std)
    return jnp.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std + jnp.log(2 * np.pi)), axis=-1
    )


class PPOLearner:
    """Builds the jitted PPO update for a given env config, optionally sharded
    over a 1-D ``envs`` ``mesh``: the env batch is then split over the mesh's
    devices and gradients are averaged over it (one all-reduce per gradient
    step).  Every env simulates the same day with the same action noise as in
    the unsharded learner at the same global batch.  Two things are per
    shard: a minibatch takes ``1/num_minibatches`` of each shard's envs (a
    draw stratified by shard, not one global permutation), and advantages are
    normalised over the shard's part of the minibatch.  The sharded update is
    therefore close to, not equal to, the unsharded one (``chip_smoke.py
    --four-cards`` reports the difference)."""

    def __init__(
        self,
        env_config: NanogridConfig,
        ppo_config: PPOConfig | None = None,
        mesh: Mesh | None = None,
        dtype=jnp.float32,
    ):
        self.env_config = env_config
        self.ppo = ppo_config or PPOConfig()
        self.mesh = mesh
        self.dtype = dtype
        self.network = ActorCritic(action_dim=env_config.num_actions)
        self.tx = optax.chain(
            optax.clip_by_global_norm(self.ppo.max_grad_norm),
            optax.adam(self.ppo.learning_rate),
        )
        low, high = env_config.action_bounds()
        self._action_low = jnp.asarray(low, dtype)
        self._action_high = jnp.asarray(high, dtype)
        self._train_step = None

    # ------------------------------------------------------------------ init --

    def init(self, key, nanogrid_params: NanogridParams, batch_size: int) -> PPOTrainState:
        """Initialise network, optimiser, and the sharded env batch."""
        k_net, k_env, k_loop = jax.random.split(key, 3)
        obs_dim = self.env_config.obs_dim
        params = self.network.init(k_net, jnp.zeros((1, obs_dim), self.dtype))
        opt_state = self.tx.init(params)

        env_keys = jax.random.split(k_env, batch_size)
        bparams = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch_size,) + x.shape), nanogrid_params
        )
        reset_fn = jax.jit(jax.vmap(functools.partial(core_reset, self.env_config)))
        env_states, obs = reset_fn(bparams, env_keys, None, None)
        self.nanogrid_params_batched = bparams

        if self.mesh is not None:
            shard = NamedSharding(self.mesh, P(ENV_AXIS))
            repl = NamedSharding(self.mesh, P())
            self.nanogrid_params_batched = jax.device_put(bparams, shard)
            env_states = jax.device_put(env_states, shard)
            obs = jax.device_put(obs, shard)
            params = jax.device_put(params, repl)
            opt_state = jax.device_put(opt_state, repl)

        return PPOTrainState(
            params=params,
            opt_state=opt_state,
            env_states=env_states,
            last_obs=obs.astype(self.dtype),
            key=k_loop,
            update_step=jnp.zeros((), jnp.int32),
        )

    def init_distributed(self, key, nanogrid_params: NanogridParams,
                         global_batch: int, seed: int = 0) -> PPOTrainState:
        """Multi-host init: host-local env-shard construction over a mesh that
        may span non-addressable devices (parallel/distributed.py).

        Each process generates only its own shard of the global env batch
        (schedules keyed by *global* env index, so they are process-count-
        invariant); learner params/optimizer are replicated from the shared
        ``key``.  Single-process this is equivalent to :meth:`init` modulo env
        key derivation."""
        if self.mesh is None:
            raise ValueError("init_distributed requires a mesh")
        from ..parallel.distributed import distributed_reset, replicate_global

        k_net, k_loop = jax.random.split(key)
        params = self.network.init(k_net, jnp.zeros((1, self.env_config.obs_dim), self.dtype))
        opt_state = self.tx.init(params)

        bparams, env_states, obs = distributed_reset(
            self.env_config, nanogrid_params, self.mesh, global_batch, seed=seed
        )
        self.nanogrid_params_batched = bparams
        params = replicate_global(params, self.mesh)
        opt_state = replicate_global(opt_state, self.mesh)
        return PPOTrainState(
            params=params,
            opt_state=opt_state,
            env_states=env_states,
            last_obs=obs.astype(self.dtype),
            key=k_loop,
            update_step=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------- train step --

    def _rollout(self, params, env_params, env_states, obs, key):
        """On-device rollout of ``rollout_days`` full days via the fused day
        scan (no per-step gathers; see core/rollout.py).

        Every day starts with a *freshly generated* schedule — the reference
        training loop resets at each episode end, which regenerates the day
        (SURVEY.md Q8/§3.4) — while the BESS state of charge carries across
        resets like the reference's persistent battery object."""
        reset_fn = jax.vmap(functools.partial(core_reset, self.env_config))
        batch = obs.shape[0]
        # days and action noise are drawn for the global env batch and each
        # shard takes its block, so under a mesh every env simulates the same
        # day with the same noise as in the unsharded learner
        global_batch = batch * (1 if self.mesh is None else self.mesh.shape[ENV_AXIS])
        noise_shape = (self.env_config.steps_per_day, global_batch, self.env_config.num_actions)

        def policy_step(ob, key_t, noise):
            mean, log_std, value = self.network.apply(params, ob)
            action = mean + jnp.exp(log_std) * noise
            logp = _gaussian_logp(mean, log_std, action)
            clipped = jnp.clip(action, self._action_low, self._action_high)
            return clipped, (ob, action, logp, value)

        pieces = []
        for d in range(self.ppo.rollout_days):
            key, k_day, k_noise = jax.random.split(key, 3)
            env_keys = shard_block(jax.random.split(k_day, global_batch), self.mesh)
            noise = shard_block(jax.random.normal(k_noise, noise_shape, self.dtype), self.mesh, axis=1)
            env_states, obs = reset_fn(env_params, env_keys, env_states.batt_soc, None)
            env_states, (obs_traj, rewards, dones, aux) = fused_day_rollout(
                self.env_config, env_params, env_states, policy_step, k_noise,
                policy_aux=True, policy_xs=noise,
            )
            ob_t, act_t, logp_t, val_t = aux
            obs = obs_traj[-1].astype(self.dtype)
            pieces.append((ob_t, act_t, logp_t, val_t, rewards.astype(self.dtype), dones))

        traj = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *pieces)
        return env_states, obs, traj

    def _gae(self, rewards, values, dones, last_value):
        """Generalised advantage estimation over the (T, B) rollout."""
        gamma, lam = self.ppo.gamma, self.ppo.gae_lambda

        def body(carry, xs):
            gae, next_value = carry
            reward, value, done = xs
            nonterminal = 1.0 - done.astype(self.dtype)
            delta = reward + gamma * next_value * nonterminal - value
            gae = delta + gamma * lam * nonterminal * gae
            return (gae, value), gae

        (_, _), advantages = jax.lax.scan(
            body,
            (jnp.zeros_like(last_value), last_value),
            (rewards, values, dones),
            reverse=True,
        )
        return advantages, advantages + values

    def _loss(self, params, obs, actions, old_logp, old_values, advantages, returns):
        mm = self.ppo.update_matmul_dtype
        if mm is not None and mm != jnp.float32:
            # mixed precision: cast params+obs for the apply only; grads flow
            # back through the cast and accumulate into the f32 master params
            p_mm = jax.tree.map(lambda x: x.astype(mm), params)
            mean, log_std, values = self.network.apply(p_mm, obs.astype(mm))
            mean = mean.astype(jnp.float32)
            log_std = log_std.astype(jnp.float32)
            values = values.astype(jnp.float32)
        else:
            mean, log_std, values = self.network.apply(params, obs)
        logp = _gaussian_logp(mean, log_std, actions)
        ratio = jnp.exp(logp - old_logp)
        norm_adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        pg1 = ratio * norm_adv
        pg2 = jnp.clip(ratio, 1 - self.ppo.clip_eps, 1 + self.ppo.clip_eps) * norm_adv
        policy_loss = -jnp.minimum(pg1, pg2).mean()
        value_loss = 0.5 * ((values - returns) ** 2).mean()
        entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * np.pi * np.e)) * jnp.ones(())
        total = policy_loss + self.ppo.vf_coef * value_loss - self.ppo.entropy_coef * entropy
        approx_kl = ((ratio - 1) - jnp.log(ratio)).mean()
        return total, (policy_loss, value_loss, entropy, approx_kl)

    def _shard_train_step(self, params, opt_state, env_params, env_states, obs, key):
        """Body executed per device shard; grads are psum-ed over the mesh."""
        k_roll, k_perm = jax.random.split(key)
        env_states, obs, traj = self._rollout(params, env_params, env_states, obs, k_roll)
        t_obs, t_act, t_logp, t_val, t_rew, t_done = traj
        _, _, last_value = self.network.apply(params, obs)
        advantages, returns = self._gae(t_rew, t_val, t_done, last_value)

        # Trajectory-wise minibatching: shuffle ENVS, not samples.  Permuting
        # the env axis gathers B rows of T·feat contiguous elements each
        # instead of T·B single-sample rows.  Each minibatch is then every
        # step of a random env subset — the same unbiased minibatch scheme as
        # SB3's RecurrentPPO sequence minibatches — re-drawn every epoch.
        # (Not a bitwise equivalent of sample-level shuffling: per-minibatch
        # advantage normalization and clipping are nonlinear in minibatch
        # composition.)  (B, T, ...) env-major layout so the per-epoch gather
        # is a leading-axis row gather, then minibatches are contiguous
        # reshaped blocks.
        def env_major(x):
            return jnp.swapaxes(x, 0, 1)

        batch = tuple(map(env_major, (t_obs, t_act, t_logp, t_val, advantages, returns)))
        n_envs = batch[0].shape[0]
        # a shard smaller than num_minibatches (tiny tests) degrades to fewer,
        # 1-env minibatches rather than empty ones
        num_mb = min(self.ppo.num_minibatches, n_envs)
        mb_envs = n_envs // num_mb

        def epoch(carry, key_e):
            params, opt_state = carry
            perm = jax.random.permutation(key_e, n_envs)[: mb_envs * num_mb]
            # one leading-axis gather per epoch, then split into minibatch
            # blocks of shape (mb_envs·T, feat...)
            mbs = tuple(
                x[perm].reshape((num_mb, -1) + x.shape[2:])
                for x in batch
            )

            def minibatch(carry, mb):
                params, opt_state = carry
                (loss, aux), grads = jax.value_and_grad(self._loss, has_aux=True)(params, *mb)
                if self.mesh is not None:
                    grads = jax.lax.pmean(grads, ENV_AXIS)
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), aux

            (params, opt_state), auxs = jax.lax.scan(minibatch, (params, opt_state), mbs)
            return (params, opt_state), auxs

        keys = jax.random.split(k_perm, self.ppo.num_epochs)
        (params, opt_state), auxs = jax.lax.scan(epoch, (params, opt_state), keys)

        steps_per_day = self.env_config.steps_per_day
        day_returns = t_rew.reshape(self.ppo.rollout_days, steps_per_day, -1).sum(axis=1)
        metrics = PPOMetrics(
            policy_loss=auxs[0].mean(),
            value_loss=auxs[1].mean(),
            entropy=auxs[2].mean(),
            approx_kl=auxs[3].mean(),
            mean_return=day_returns.mean(),
        )
        if self.mesh is not None:
            metrics = jax.tree.map(lambda m: jax.lax.pmean(m, ENV_AXIS), metrics)
        return params, opt_state, env_states, obs, metrics

    def build_train_step(self):
        """The jitted (optionally shard_map-ped) train step."""
        if self._train_step is not None:
            return self._train_step
        self._train_step = jax.jit(self._make_train_step_body())
        return self._train_step

    def build_train_many(self, updates_per_call: int):
        """One jitted program running ``updates_per_call`` full PPO updates
        (rollout + GAE + the epoch×minibatch sweep each) via ``lax.scan``.

        One dispatch then covers many updates, so the host round-trip per
        update drops out — this is also the deployment shape (the reference's
        training run is 2,125 sequential updates,
        solvers/RL/ppo_train.py:94-102).  Returns
        ``train_many(state, env_params) -> (state, metrics)`` with metrics
        stacked over the call's updates."""

        def train_many(state: PPOTrainState, env_params):
            single = self._make_train_step_body()

            def body(state, _):
                return single(state, env_params)

            return jax.lax.scan(body, state, length=updates_per_call)

        return jax.jit(train_many)

    def _make_train_step_body(self):
        """The un-jitted single-update body shared by build_train_step and
        build_train_many."""

        def train_step(state: PPOTrainState, env_params) -> tuple[PPOTrainState, PPOMetrics]:
            key, sub = jax.random.split(state.key)
            if self.mesh is not None:
                spec = P(ENV_AXIS)
                body = jax.shard_map(
                    self._shard_train_step,
                    mesh=self.mesh,
                    in_specs=(P(), P(), spec, spec, spec, P()),
                    out_specs=(P(), P(), spec, spec, P()),
                    check_vma=False,
                )
            else:
                body = self._shard_train_step
            params, opt_state, env_states, obs, metrics = body(
                state.params, state.opt_state, env_params, state.env_states, state.last_obs, sub
            )
            return (
                PPOTrainState(params, opt_state, env_states, obs, key, state.update_step + 1),
                metrics,
            )

        return train_step

    # ---------------------------------------------------------------- driving --

    def train(self, state: PPOTrainState, num_updates: int, log_every: int = 0):
        """Run ``num_updates`` train steps; returns final state + metric history."""
        step_fn = self.build_train_step()
        history = []
        for i in range(num_updates):
            state, metrics = step_fn(state, self.nanogrid_params_batched)
            if log_every and (i % log_every == 0 or i == num_updates - 1):
                m = jax.tree.map(lambda x: float(x), metrics)
                history.append(m)
        return state, history

    def policy_fn(self, params, deterministic=True):
        """Policy callable ``(obs, key) -> clipped actions`` for evaluation."""

        def policy(obs, key=None):
            mean, log_std, _ = self.network.apply(params, obs)
            action = mean
            if not deterministic and key is not None:
                action = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape, self.dtype)
            return jnp.clip(action, self._action_low, self._action_high)

        return policy
