"""Test harness setup.

Tests run on the CPU JAX platform (the "fake backend" role the reference's
NdArray backend plays, SURVEY.md §4) with 8 virtual devices so multi-chip
sharding logic is testable without TPU hardware.
"""

import os

# Must be set before jax is imported anywhere in the test process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Full-precision matmuls on CPU so torch-vs-jax parity is tight.
jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (inside the test) where there is none"
    )
