"""smart_nanogrid_gym_tpu — a smart-nanogrid environment engine for JAX accelerators.

A from-scratch re-design of the capabilities of Dellintel98/smart-nanogrid-gym
(the reference) as a pure-functional JAX framework: one jittable step function vmapped over thousands of env instances,
counter-based PRNG schedules, device-mesh sharding for multi-host scale, and
actor-learner training (PPO/DDPG) fully on device.

See SURVEY.md at the repo root for the reference analysis this build follows.
"""

__version__ = "0.1.0"

__all__ = [
    "NanogridConfig",
    "NanogridParams",
    "PenaltyMode",
    "SmartNanogridTPU",
    "make_params",
]

_CONFIG_ONLY = {"NanogridConfig", "PenaltyMode"}


def __getattr__(name):
    # Lazy so that the native serving path (smart_nanogrid_gym_tpu.native) can
    # be used on hosts without importing JAX; NanogridConfig itself is
    # JAX-free (core.config).
    if name in _CONFIG_ONLY:
        from .core import config as _config

        return getattr(_config, name)
    if name in __all__:
        from . import core as _core

        return getattr(_core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
