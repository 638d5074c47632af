"""Test harness setup.

Tests run on the CPU with 8 virtual devices, so sharding logic is
exercised without a GPU.  Both settings are made before JAX is imported:
it reads ``JAX_PLATFORMS`` at import and ``XLA_FLAGS`` when the CPU client
starts.  The run on the card is ``python chip_smoke.py``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# in case JAX was imported before this file (by a site hook)
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
