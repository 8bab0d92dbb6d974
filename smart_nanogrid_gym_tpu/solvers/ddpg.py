"""On-device DDPG learner (reference: solvers/RL/ddpg_train.py).

The reference trains SB3 DDPG with Ornstein-Uhlenbeck action noise (σ=0.5,
ddpg_train.py:111) against one Python env.  Here the full loop — vectorized env
stepping, a device-resident circular replay buffer, OU noise per env, target
networks with polyak averaging — is one jitted program; the host loop only
counts updates.

Defaults follow SB3 DDPG: actor/critic 400-300 ReLU, lr 1e-3, γ 0.99, τ 5e-3,
batch 256.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout
from ..core.transition import reset as core_reset, step as core_step
from ..parallel.mesh import ENV_AXIS, shard_block
from .networks import DDPGActor, DDPGCritic


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    learning_rate: float = 1e-3
    gamma: float = 0.99
    tau: float = 5e-3
    batch_size: int = 256
    buffer_days: int = 50          # replay capacity in days of the env batch
    ou_sigma: float = 0.5          # reference ddpg_train.py:111
    ou_theta: float = 0.15
    ou_dt: float = 1e-2            # SB3 OrnsteinUhlenbeckActionNoise default
    steps_per_update: int = 24     # env steps collected per train call (one day)
    gradient_steps: int = 24


class ReplayBuffer(NamedTuple):
    obs: jnp.ndarray       # (C, B, obs_dim)
    actions: jnp.ndarray   # (C, B, act_dim)
    rewards: jnp.ndarray   # (C, B)
    next_obs: jnp.ndarray  # (C, B, obs_dim)
    dones: jnp.ndarray     # (C, B)
    insert_pos: jnp.ndarray
    filled: jnp.ndarray


class DDPGTrainState(NamedTuple):
    actor_params: dict
    critic_params: dict
    target_actor_params: dict
    target_critic_params: dict
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    buffer: ReplayBuffer
    env_states: object
    last_obs: jnp.ndarray
    ou_state: jnp.ndarray  # (B, act_dim) Ornstein-Uhlenbeck noise state
    key: jnp.ndarray
    update_step: jnp.ndarray


def ou_step(ou, gaussian, theta, sigma, dt, mu=0.0):
    """One Ornstein-Uhlenbeck discretisation step, exactly SB3's
    ``OrnsteinUhlenbeckActionNoise.__call__``:
    ``x' = x + theta*(mu - x)*dt + sigma*sqrt(dt)*N`` with defaults
    theta=0.15, dt=1e-2 (the reference passes sigma=0.5, ddpg_train.py:111).
    ``gaussian`` is the standard-normal sample (injected so tests can pin the
    recurrence against the SB3 formula with a shared sample)."""
    return ou + theta * (mu - ou) * dt + sigma * jnp.sqrt(jnp.asarray(dt, ou.dtype)) * gaussian


class DDPGLearner:
    """Builds the jitted DDPG update for a given env config, optionally
    sharded over a 1-D ``envs`` ``mesh``: the env batch and the replay buffer
    are then split over the mesh's devices.  Collection is the unsharded learner's at the same global batch:
    every env simulates the same day with the same OU noise.  Each gradient
    step, every shard samples ``batch_size`` transitions from its own block of
    the buffer and the gradients are averaged over the mesh, so the global
    replay batch is ``batch_size`` times the number of devices."""

    def __init__(self, env_config: NanogridConfig, ddpg_config: DDPGConfig | None = None,
                 mesh=None, dtype=jnp.float32):
        self.env_config = env_config
        self.cfg = ddpg_config or DDPGConfig()
        self.mesh = mesh
        self.dtype = dtype
        low, high = env_config.action_bounds()
        self.actor = DDPGActor(env_config.num_actions, tuple(low.tolist()), tuple(high.tolist()))
        self.critic = DDPGCritic()
        self._action_low = jnp.asarray(low, dtype)
        self._action_high = jnp.asarray(high, dtype)
        self._train_step = None
        # test hook: route whole-day collects through the sequential fallback
        # so the fused path can be pinned against it (tests/test_ddpg_eval.py)
        self._force_sequential_collect = False

    def init(self, key, nanogrid_params: NanogridParams, batch_size: int) -> DDPGTrainState:
        k_a, k_c, k_env, k_loop = jax.random.split(key, 4)
        obs_dim = self.env_config.obs_dim
        act_dim = self.env_config.num_actions
        dummy_obs = jnp.zeros((1, obs_dim), self.dtype)
        dummy_act = jnp.zeros((1, act_dim), self.dtype)
        actor_params = self.actor.init(k_a, dummy_obs)
        critic_params = self.critic.init(k_c, dummy_obs, dummy_act)
        self.actor_tx = optax.adam(self.cfg.learning_rate)
        self.critic_tx = optax.adam(self.cfg.learning_rate)

        env_keys = jax.random.split(k_env, batch_size)
        bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch_size,) + x.shape), nanogrid_params)
        reset_fn = jax.jit(jax.vmap(functools.partial(core_reset, self.env_config)))
        env_states, obs = reset_fn(bparams, env_keys, None, None)
        self.nanogrid_params_batched = bparams

        C = self.cfg.buffer_days * self.env_config.steps_per_day
        buffer = ReplayBuffer(
            obs=jnp.zeros((C, batch_size, obs_dim), self.dtype),
            actions=jnp.zeros((C, batch_size, act_dim), self.dtype),
            rewards=jnp.zeros((C, batch_size), self.dtype),
            next_obs=jnp.zeros((C, batch_size, obs_dim), self.dtype),
            dones=jnp.zeros((C, batch_size), bool),
            insert_pos=jnp.zeros((), jnp.int32),
            filled=jnp.zeros((), jnp.int32),
        )
        return DDPGTrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_actor_params=actor_params,
            target_critic_params=critic_params,
            actor_opt=self.actor_tx.init(actor_params),
            critic_opt=self.critic_tx.init(critic_params),
            buffer=buffer,
            env_states=env_states,
            last_obs=obs.astype(self.dtype),
            ou_state=jnp.zeros((batch_size, act_dim), self.dtype),
            key=k_loop,
            update_step=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------------ body --

    def _collect(self, state: DDPGTrainState, env_params, key):
        """Collect steps_per_update env steps with OU exploration noise.

        Each collect starts a freshly generated day (reference: new day per
        episode reset, battery carried — SURVEY.md Q8/§3.4).  OU noise follows
        SB3's discretisation: x += theta*(mu-x)*dt + sigma*sqrt(dt)*N with
        dt=1e-2 (sb3 OrnsteinUhlenbeckActionNoise defaults, used by
        ddpg_train.py:111 with sigma=0.5).

        When the collect window is exactly one day, stepping runs through
        :func:`..core.rollout.fused_day_rollout` — the same fused day scan the
        PPO learner uses: no per-step table gathers, and the day's transitions
        land in the replay buffer as ONE contiguous block write instead of 24
        row updates.  The OU recurrence depends only on its own gaussians, so
        its whole sequence is computed before the day scan and fed per-step
        via ``policy_xs``.
        """
        key, k_day = jax.random.split(key)
        reset_fn = jax.vmap(functools.partial(core_reset, self.env_config))
        batch = state.last_obs.shape[0]
        # days and exploration noise are drawn for the global env batch and
        # each shard takes its block (as in the PPO learner)
        global_batch = batch * (1 if self.mesh is None else self.mesh.shape[ENV_AXIS])
        env_keys = shard_block(jax.random.split(k_day, global_batch), self.mesh)
        env_states0, obs0 = reset_fn(env_params, env_keys, state.env_states.batt_soc, None)

        theta, sigma, ou_dt = self.cfg.ou_theta, self.cfg.ou_sigma, self.cfg.ou_dt
        T = self.cfg.steps_per_update
        # SB3 resets the OU noise process at each episode end; every collect is
        # a fresh episode, so start from zero noise state.
        ou0 = jnp.zeros_like(state.ou_state)

        key, k_noise, k_roll = jax.random.split(key, 3)
        gaussians = shard_block(
            jax.random.normal(k_noise, (T, global_batch) + ou0.shape[1:], self.dtype),
            self.mesh, axis=1)

        def ou_scan(ou, g_t):
            ou = ou_step(ou, g_t, theta, sigma, ou_dt)
            return ou, ou

        ou_final, ou_seq = jax.lax.scan(ou_scan, ou0, gaussians)

        if T == self.env_config.steps_per_day and not self._force_sequential_collect:
            def policy_step(ob, key_t, ou_t):
                a = self.actor.apply(state.actor_params, ob)
                a = jnp.clip(a + ou_t, self._action_low, self._action_high)
                return a, (ob, a)

            env_states, (obs_traj, rewards, dones, aux) = fused_day_rollout(
                self.env_config, env_params, env_states0, policy_step, k_roll,
                policy_aux=True, policy_xs=ou_seq,
            )
            t_obs, t_act = aux
            obs = obs_traj[-1].astype(self.dtype)
            buffer = self._insert_day(
                state.buffer, t_obs.astype(self.dtype), t_act.astype(self.dtype),
                rewards.astype(self.dtype), obs_traj.astype(self.dtype), dones,
            )
            return env_states, obs, ou_final, buffer, rewards

        # general fallback: partial-day collect windows step sequentially
        step_fn = jax.vmap(functools.partial(core_step, self.env_config))

        def body(carry, xs):
            env_states, obs, buffer = carry
            ou_t = xs
            action_det = self.actor.apply(state.actor_params, obs)
            action = jnp.clip(action_det + ou_t, self._action_low, self._action_high)
            res = step_fn(env_params, env_states, action)
            pos = buffer.insert_pos
            C = buffer.obs.shape[0]
            buffer = buffer._replace(
                obs=jax.lax.dynamic_update_index_in_dim(buffer.obs, obs, pos, 0),
                actions=jax.lax.dynamic_update_index_in_dim(buffer.actions, action, pos, 0),
                rewards=jax.lax.dynamic_update_index_in_dim(
                    buffer.rewards, res.reward.astype(self.dtype), pos, 0
                ),
                next_obs=jax.lax.dynamic_update_index_in_dim(
                    buffer.next_obs, res.obs.astype(self.dtype), pos, 0
                ),
                dones=jax.lax.dynamic_update_index_in_dim(buffer.dones, res.done, pos, 0),
                insert_pos=(pos + 1) % C,
                filled=jnp.minimum(buffer.filled + 1, C),
            )
            return (res.state, res.obs.astype(self.dtype), buffer), res.reward

        (env_states, obs, buffer), rewards = jax.lax.scan(
            body, (env_states0, obs0.astype(self.dtype), state.buffer), ou_seq
        )
        return env_states, obs, ou_final, buffer, rewards

    @staticmethod
    def _insert_day(buffer: ReplayBuffer, t_obs, t_act, rewards, next_obs, dones):
        """Insert a whole (T, B, ...) day block at insert_pos.

        Capacity is a multiple of steps_per_day and whole-day inserts keep
        ``insert_pos`` block-aligned, so the write never wraps mid-block.
        (``dynamic_update_slice_in_dim`` clamps out-of-range starts silently,
        which would corrupt the buffer if the invariant broke — so it is
        enforced at trace time, ADVICE r4.)"""
        T = t_obs.shape[0]
        C = buffer.obs.shape[0]
        if C % T != 0:
            raise ValueError(
                f"replay capacity {C} must be a multiple of the day block {T}: "
                "whole-day inserts assume block-aligned insert_pos (no mid-"
                "block wrap); dynamic_update_slice would silently clamp"
            )
        pos = buffer.insert_pos
        upd = lambda buf, x: jax.lax.dynamic_update_slice_in_dim(buf, x, pos, 0)
        return buffer._replace(
            obs=upd(buffer.obs, t_obs),
            actions=upd(buffer.actions, t_act),
            rewards=upd(buffer.rewards, rewards),
            next_obs=upd(buffer.next_obs, next_obs),
            dones=upd(buffer.dones, dones),
            insert_pos=(pos + T) % C,
            filled=jnp.minimum(buffer.filled + T, C),
        )

    def _sample(self, buffer: ReplayBuffer, key):
        B = buffer.obs.shape[1]
        k1, k2 = jax.random.split(key)
        t_idx = jax.random.randint(k1, (self.cfg.batch_size,), 0, jnp.maximum(buffer.filled, 1))
        b_idx = jax.random.randint(k2, (self.cfg.batch_size,), 0, B)
        return (
            buffer.obs[t_idx, b_idx],
            buffer.actions[t_idx, b_idx],
            buffer.rewards[t_idx, b_idx],
            buffer.next_obs[t_idx, b_idx],
            buffer.dones[t_idx, b_idx],
        )

    def _train_body(self, state: DDPGTrainState, env_params):
        key, k_collect, k_grad = jax.random.split(state.key, 3)
        if self.mesh is not None:
            # each shard samples its own replay block; state.key itself stays
            # replicated
            k_grad = jax.random.fold_in(k_grad, jax.lax.axis_index(ENV_AXIS))
        env_states, obs, ou, buffer, rewards = self._collect(state, env_params, k_collect)
        gamma = self.cfg.gamma
        tau = self.cfg.tau

        def gradient_step(carry, key_g):
            actor_params, critic_params, t_actor, t_critic, a_opt, c_opt = carry
            b_obs, b_act, b_rew, b_next, b_done = self._sample(buffer, key_g)

            next_action = self.actor.apply(t_actor, b_next)
            target_q = b_rew + gamma * (1.0 - b_done.astype(self.dtype)) * self.critic.apply(
                t_critic, b_next, next_action
            )

            def critic_loss(p):
                q = self.critic.apply(p, b_obs, b_act)
                return ((q - target_q) ** 2).mean()

            c_loss, c_grads = jax.value_and_grad(critic_loss)(critic_params)
            if self.mesh is not None:
                c_grads = jax.lax.pmean(c_grads, ENV_AXIS)
            c_updates, c_opt = self.critic_tx.update(c_grads, c_opt, critic_params)
            critic_params = optax.apply_updates(critic_params, c_updates)

            def actor_loss(p):
                a = self.actor.apply(p, b_obs)
                return -self.critic.apply(critic_params, b_obs, a).mean()

            a_loss, a_grads = jax.value_and_grad(actor_loss)(actor_params)
            if self.mesh is not None:
                a_grads = jax.lax.pmean(a_grads, ENV_AXIS)
            a_updates, a_opt = self.actor_tx.update(a_grads, a_opt, actor_params)
            actor_params = optax.apply_updates(actor_params, a_updates)

            polyak = lambda t, p: jax.tree.map(lambda a, b: (1 - tau) * a + tau * b, t, p)
            t_actor = polyak(t_actor, actor_params)
            t_critic = polyak(t_critic, critic_params)
            return (actor_params, critic_params, t_actor, t_critic, a_opt, c_opt), (c_loss, a_loss)

        keys = jax.random.split(k_grad, self.cfg.gradient_steps)
        carry = (
            state.actor_params, state.critic_params,
            state.target_actor_params, state.target_critic_params,
            state.actor_opt, state.critic_opt,
        )
        carry, (c_losses, a_losses) = jax.lax.scan(gradient_step, carry, keys)
        actor_params, critic_params, t_actor, t_critic, a_opt, c_opt = carry

        new_state = DDPGTrainState(
            actor_params, critic_params, t_actor, t_critic, a_opt, c_opt,
            buffer, env_states, obs, ou, key, state.update_step + 1,
        )
        metrics = {
            "critic_loss": c_losses.mean(),
            "actor_loss": a_losses.mean(),
            "mean_return": rewards.sum(axis=0).mean(),
        }
        if self.mesh is not None:
            metrics = jax.tree.map(lambda m: jax.lax.pmean(m, ENV_AXIS), metrics)
        return new_state, metrics

    def _make_body(self):
        """The un-jitted (optionally shard_map-ped) single-update body."""
        if self.mesh is None:
            return self._train_body
        from jax.sharding import PartitionSpec as P

        spec_env = P(ENV_AXIS)        # leading env axis
        spec_buf = P(None, ENV_AXIS)  # replay buffer: (capacity, B, ...)
        state_specs = DDPGTrainState(
            actor_params=P(), critic_params=P(),
            target_actor_params=P(), target_critic_params=P(),
            actor_opt=P(), critic_opt=P(),
            buffer=ReplayBuffer(
                obs=spec_buf, actions=spec_buf, rewards=spec_buf,
                next_obs=spec_buf, dones=spec_buf,
                insert_pos=P(), filled=P(),
            ),
            env_states=spec_env, last_obs=spec_env, ou_state=spec_env,
            key=P(), update_step=P(),
        )
        return jax.shard_map(
            self._train_body,
            mesh=self.mesh,
            in_specs=(state_specs, spec_env),
            out_specs=(state_specs, P()),
            check_vma=False,
        )

    def build_train_step(self):
        if self._train_step is None:
            self._train_step = jax.jit(self._make_body())
        return self._train_step

    def build_train_many(self, updates_per_call: int):
        """One jitted program scanning ``updates_per_call`` full DDPG updates
        (collect day + gradient sweep each) — one dispatch for many updates,
        like PPOLearner.build_train_many.  Returns ``train_many(state, env_params) -> (state,
        metrics)`` with metrics stacked over the call's updates."""
        body = self._make_body()

        def train_many(state: DDPGTrainState, env_params):
            def step(state, _):
                return body(state, env_params)

            return jax.lax.scan(step, state, length=updates_per_call)

        return jax.jit(train_many)

    def train(self, state, num_updates, log_every=0):
        step_fn = self.build_train_step()
        history = []
        for i in range(num_updates):
            state, metrics = step_fn(state, self.nanogrid_params_batched)
            if log_every and (i % log_every == 0 or i == num_updates - 1):
                history.append({k: float(v) for k, v in metrics.items()})
        return state, history

    def policy_fn(self, actor_params):
        def policy(obs, key=None):
            return self.actor.apply(actor_params, obs)

        return policy
