"""Run the tests on a virtual 8-device CPU mesh.

``JAX_PLATFORMS=cpu`` keeps JAX off any accelerator, the forced host device
count gives the distributed tests their mesh, and the persistent compile
cache is off: XLA:CPU executables compiled here must not land in the
checkout's cache, which travels with the checkout to other machines.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)
