"""Torch-free loader for the reference's shipped SB3 PPO checkpoints.

The reference trains with stable-baselines3 and ships 50 PPO checkpoints
(reference: solvers/RL/models/PPO-b-pv-bounded-sparse-4ch-1h/0.zip …
999600.zip, saved by solvers/RL/ppo_train.py:102) which its evaluator and
predictor load back (reference: solvers/evaluator.py:49-77,
solvers/predictor.py:60-74).  This module ingests those artifacts directly —
no torch, no SB3 — so the one concrete trained-policy ground truth in the
reference ecosystem runs on this engine:

- an SB3 ``.zip`` holds ``policy.pth`` (a torch-zip serialized state_dict of
  plain float32 tensors) plus a ``data`` JSON of hyperparameters;
- ``policy.pth`` is parsed with a restricted unpickler: the only constructs a
  torch state_dict uses are ``collections.OrderedDict``, ``torch.*Storage``
  markers, persistent-id storage references, and
  ``torch._utils._rebuild_tensor_v2`` — each is re-implemented over numpy;
- the tensors are re-laid-out into the :class:`..solvers.networks.
  ActorCritic` param pytree (same 64-64 tanh torso as SB3's default MlpPolicy).

The resulting params run through every evaluation path in this framework
(paired same-day comparison, single-day prediction, and the at-scale
evaluator).
"""

from __future__ import annotations

import io
import json
import pickle
import zipfile
from typing import Any

import numpy as np

_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


class _StorageType:
    """Marker standing in for ``torch.FloatStorage`` etc. in the pickle."""

    def __init__(self, dtype):
        self.dtype = dtype


class _Storage:
    """A raw storage buffer read from the torch zip."""

    def __init__(self, data: bytes, dtype):
        self.array = np.frombuffer(data, dtype=dtype)


def _rebuild_tensor_v2(storage, storage_offset, size, stride, requires_grad,
                       backward_hooks, metadata=None):
    """numpy re-implementation of ``torch._utils._rebuild_tensor_v2``."""
    flat = storage.array
    itemsize = flat.dtype.itemsize
    return np.lib.stride_tricks.as_strided(
        flat[storage_offset:],
        shape=tuple(size),
        strides=tuple(s * itemsize for s in stride),
    ).copy()


class _TorchUnpickler(pickle.Unpickler):
    """Restricted unpickler: admits exactly the constructs a plain torch
    state_dict serialization uses; everything else raises."""

    def __init__(self, file, inner_zip: zipfile.ZipFile, prefix: str):
        super().__init__(file)
        self._zip = inner_zip
        self._prefix = prefix

    def find_class(self, module: str, name: str):
        if module == "collections" and name == "OrderedDict":
            import collections

            return collections.OrderedDict
        if module == "torch._utils" and name == "_rebuild_tensor_v2":
            return _rebuild_tensor_v2
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(_STORAGE_DTYPES[name])
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not a plain tensor payload)"
        )

    def persistent_load(self, pid: Any):
        # ('storage', storage_type, key, location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        _, storage_type, key, _location, _numel = pid
        data = self._zip.read(f"{self._prefix}/data/{key}")
        return _Storage(data, storage_type.dtype)


def load_torch_state_dict(payload: bytes) -> dict[str, np.ndarray]:
    """Parse a torch-zip-serialized state_dict (e.g. SB3's ``policy.pth``)
    into ``{name: numpy array}`` without importing torch."""
    inner = zipfile.ZipFile(io.BytesIO(payload))
    pkl_name = next(n for n in inner.namelist() if n.endswith("/data.pkl"))
    prefix = pkl_name.rsplit("/", 1)[0]
    unpickler = _TorchUnpickler(io.BytesIO(inner.read(pkl_name)), inner, prefix)
    return dict(unpickler.load())


def load_sb3_zip(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load an SB3 checkpoint zip → (policy state_dict, hyperparameter dict).

    The hyperparameter dict is the checkpoint's ``data`` JSON with the
    cloudpickle-serialized entries (spaces, schedules) left as-is; scalar
    hyperparameters (gamma, gae_lambda, clip_range, …) are plain values.
    """
    with zipfile.ZipFile(path) as z:
        state = load_torch_state_dict(z.read("policy.pth"))
        data = json.loads(z.read("data").decode("utf-8"))
    return state, data


# ---------------------------------------------------------------------------
# SB3 MlpPolicy (PPO default) → ActorCritic params
# ---------------------------------------------------------------------------

_PPO_TENSOR_NAMES = (
    "log_std",
    "mlp_extractor.policy_net.0.weight", "mlp_extractor.policy_net.0.bias",
    "mlp_extractor.policy_net.2.weight", "mlp_extractor.policy_net.2.bias",
    "mlp_extractor.value_net.0.weight", "mlp_extractor.value_net.0.bias",
    "mlp_extractor.value_net.2.weight", "mlp_extractor.value_net.2.bias",
    "action_net.weight", "action_net.bias",
    "value_net.weight", "value_net.bias",
)


def actor_critic_params_from_sb3(state: dict[str, np.ndarray]) -> dict:
    """Map an SB3 default-MlpPolicy PPO state_dict onto the
    :class:`..solvers.networks.ActorCritic` param pytree.

    SB3's ActorCriticPolicy (default net_arch) is two separate 64-64 tanh
    torsos (``mlp_extractor.policy_net`` / ``value_net``) with linear heads
    (``action_net`` / ``value_net``) and a state-independent ``log_std`` —
    exactly the ActorCritic architecture here.  torch Linear stores weights
    as (out, in); the ActorCritic kernels as (in, out), hence the transposes.
    """
    missing = [n for n in _PPO_TENSOR_NAMES if n not in state]
    if missing:
        raise ValueError(
            f"not an SB3 default-MlpPolicy PPO checkpoint; missing {missing}"
        )

    def dense(weight_key, bias_key):
        return {
            "kernel": np.ascontiguousarray(state[weight_key].T, dtype=np.float32),
            "bias": np.asarray(state[bias_key], dtype=np.float32),
        }

    return {
        "params": {
            "pi": {
                "Dense_0": dense("mlp_extractor.policy_net.0.weight",
                                 "mlp_extractor.policy_net.0.bias"),
                "Dense_1": dense("mlp_extractor.policy_net.2.weight",
                                 "mlp_extractor.policy_net.2.bias"),
                "Dense_2": dense("action_net.weight", "action_net.bias"),
            },
            "vf": {
                "Dense_0": dense("mlp_extractor.value_net.0.weight",
                                 "mlp_extractor.value_net.0.bias"),
                "Dense_1": dense("mlp_extractor.value_net.2.weight",
                                 "mlp_extractor.value_net.2.bias"),
                "Dense_2": dense("value_net.weight", "value_net.bias"),
            },
            "log_std": np.asarray(state["log_std"], dtype=np.float32),
        }
    }


def load_sb3_actor_critic(path: str, config=None) -> tuple[dict, dict]:
    """Load an SB3 PPO zip into ActorCritic params, validating shapes against
    ``config`` when given.  Returns ``(net_params, hyperparams)``."""
    state, data = load_sb3_zip(path)
    net_params = actor_critic_params_from_sb3(state)
    obs_dim = net_params["params"]["pi"]["Dense_0"]["kernel"].shape[0]
    action_dim = net_params["params"]["pi"]["Dense_2"]["kernel"].shape[1]
    if config is not None:
        if obs_dim != config.obs_dim or action_dim != config.num_actions:
            raise ValueError(
                f"checkpoint is ({obs_dim} obs, {action_dim} actions) but the "
                f"config needs ({config.obs_dim}, {config.num_actions}) — the "
                f"reference's shipped models are b-pv 4-charger 1h "
                f"(solvers/RL/models/PPO-b-pv-bounded-sparse-4ch-1h)"
            )
    hyper = {
        k: data.get(k)
        for k in ("gamma", "gae_lambda", "ent_coef", "vf_coef", "clip_range",
                  "n_steps", "batch_size", "n_epochs", "num_timesteps")
    }
    return net_params, hyper


def make_sb3_policy_fn(config, net_params):
    """Deterministic SB3 ``model.predict`` equivalent: actor mean, clipped to
    the action box (SB3 clips unsquashed Gaussian policies to the space;
    reference evaluation drives exactly this, solvers/evaluator.py:13-24)."""
    import jax.numpy as jnp

    from ..solvers.networks import ActorCritic

    network = ActorCritic(action_dim=config.num_actions)
    low, high = config.action_bounds()
    low, high = jnp.asarray(low), jnp.asarray(high)

    def policy(obs, key=None):
        mean, _, _ = network.apply(net_params, obs)
        return jnp.clip(mean, low, high)

    return policy
