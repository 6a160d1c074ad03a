"""Test configuration: force an 8-virtual-device CPU platform.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding
paths are validated on 8 virtual CPU devices. The platform is also forced
through ``jax.config`` in case JAX was imported before this file.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

