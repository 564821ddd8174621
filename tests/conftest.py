"""Test configuration: force CPU with 8 virtual devices.

Tests run on the CPU; multi-chip sharding is validated on a virtual
8-device CPU mesh, and the program's GPU path is exercised on the card
by ``python chip_smoke.py``.  XLA_FLAGS must be set before the CPU client
is instantiated (first ``jax.devices()`` anywhere), which this
module-level code guarantees under pytest.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root():
    if not REFERENCE.exists():
        pytest.skip("reference corpus not available")
    return REFERENCE


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "corpus: heavy raw-corpus harness (feature extraction over many "
        "PCDs); excluded from the default run — select with -m corpus",
    )


def pytest_collection_modifyitems(config, items):
    # default suite stays fast (~CLAUDE.md's contract): big-corpus
    # extraction harnesses run only when the -m expression mentions the
    # corpus marker (an unrelated filter like -m "not slow" must not
    # accidentally pull the multi-minute harnesses back in)
    if "corpus" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(reason="corpus harness — run with -m corpus")
    for item in items:
        if "corpus" in item.keywords:
            item.add_marker(skip)
