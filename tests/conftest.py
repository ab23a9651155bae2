"""Test environment: force the CPU backend with 8 virtual devices so that
sharding/multi-device tests run without an accelerator (SURVEY.md §4).

The platform is pinned programmatically before any backend is initialized,
so the suite stays on the CPU even where JAX would pick a GPU by default.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
