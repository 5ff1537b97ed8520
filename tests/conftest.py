"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding (element partitioning + halo exchange, scenario
batching) is exercised without accelerators by forcing the host platform to
expose 8 devices — the same mechanism `__graft_entry__.dryrun_multichip`
uses. The platform is forced to the CPU even where a GPU is present, so the
tests see the same devices everywhere; `python chip_smoke.py` exercises the
GPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", jax.devices()
