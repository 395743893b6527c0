"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The platform is forced through jax.config (not only the JAX_PLATFORMS
variable) before any backend initializes, so the suite runs on the CPU even
on a machine with a GPU. chip_smoke.py and bench.py are the on-card paths.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
