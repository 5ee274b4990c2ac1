"""Test config: force CPU with 8 virtual devices BEFORE jax backend init.

The analog of "test multi-node without a cluster" (SURVEY.md §4): sharding
tests run on a simulated 8-device host mesh. The tests never use an
accelerator, even where one is present; ``python chip_smoke.py`` is the
on-card check.
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
jax.config.update("jax_default_matmul_precision", "highest")
