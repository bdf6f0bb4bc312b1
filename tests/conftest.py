"""Shared test setup: put ``src`` on sys.path and install the jax
forward-compat shims (``jax.shard_map``, ``jax.sharding.AxisType``,
``make_mesh(axis_types=...)``) before any test module touches jax."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "src"))
# repo root, so tests can import the benchmarks/ modules they exercise
sys.path.insert(1, os.path.join(os.path.dirname(__file__), os.pardir))

import repro.dist  # noqa: E402,F401  (import side effect: compat shims)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card and nvcc (the port's CUDA "
        "kernels); skips inside a fixture elsewhere")


def pytest_report_header(config):
    """Say up front whether the property tests run on real hypothesis or
    the seeded-loop fallback (tests/_propshim.py) — so a CI log always
    records which engine produced the run."""
    try:
        import hypothesis
        return f"property tests: hypothesis {hypothesis.__version__}"
    except ImportError:
        return ("property tests: hypothesis NOT installed — seeded-loop "
                "fallback (tests/_propshim.py; no shrinking)")
