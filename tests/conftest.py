"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices, so
multi-device sharding is validated on a virtual mesh, and with x64 enabled so
oracle trajectory tests can match the reference's float64 numpy compute
(envs cast observations to float32 at the end, like the reference does at
smart_nanogrid_environment.py:224-229).  Tests that hold an f32 program to a
tolerance scope x64 off themselves.  The GPU is exercised by
``python chip_smoke.py`` (and ``--four-cards`` for the sharded learner).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])
# the CLIs point the persistent compilation cache at the repo; tests neither
# read nor write it
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
