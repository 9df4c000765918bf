"""Test configuration.

The suite runs on a virtual 8-device CPU mesh: JAX is forced onto the
CPU before any test module imports it, and multi-device sharding is
validated on that mesh. ``python -m pytest -m gpu`` (on a machine with
an NVIDIA GPU) leaves the platform alone and runs the tests marked
``gpu``, which compare the device paths with their references; without a
card they skip.
"""
import os

import numpy as np
import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


@pytest.fixture(scope="session")
def make_seq(rng):
    def _make(n, alphabet="ACGT"):
        return random_seq(rng, n, alphabet)
    return _make


@pytest.fixture(scope="session")
def adapters_dir(tmp_path_factory):
    """Seeded adapter/primer banks in the reference's adapters_primers
    layout (nano_orc.synth.write_banks)."""
    from nano_orc import synth
    return synth.write_banks(str(tmp_path_factory.mktemp("adapters")),
                             seed=0)


@pytest.fixture
def gpu():
    """Skips unless JAX's default device is an NVIDIA GPU."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
