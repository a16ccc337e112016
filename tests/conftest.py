"""Test configuration: force CPU with 8 virtual devices.

SURVEY.md §4 test strategy: multi-chip sharding logic is validated on a
virtual CPU mesh (xla_force_host_platform_device_count) so tests run without
accelerator hardware; numerical kernels are compared against NumPy oracles.

Note: env vars alone are not enough — pytest plugins may import jax before
this file runs, so also force the platform through jax.config (works as long
as no backend has been initialized yet).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
