"""Test harness config: run everything on a simulated 8-device CPU mesh.

Set platform env vars BEFORE jax is imported anywhere (the SURVEY §4
Vagrant-analogue: multi-device behavior without a pod).

``MSM_TEST_GPU=1`` leaves the platform to JAX instead, for the tests marked
``gpu`` (``MSM_TEST_GPU=1 python -m pytest -m gpu tests/`` on a machine with
an NVIDIA GPU); whether a card is there is decided by the ``gpu`` fixture.
"""

import os

ON_CARD = os.environ.get("MSM_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pathlib
import pytest

import jax

if not ON_CARD:
    # Pin the platform in process as well, so that a machine with a GPU
    # still runs the suite on the 8-device CPU mesh.
    jax.config.update("jax_platforms", "cpu")

# Backend guard: nothing in this repo may touch a device at import time
# (api/ops call jax.default_backend only at runtime, after the forced-cpu
# config above).  A module that did would have initialized a backend before
# the override, and tests would then run on the wrong platform — fail
# LOUDLY here instead.
from jax._src import xla_bridge as _xb  # noqa: E402

assert not _xb._backends, (
    "a JAX backend initialized before conftest forced jax_platforms=cpu: "
    f"{list(_xb._backends)} — something at import time touched a device"
)
assert ON_CARD or jax.default_backend() == "cpu", (
    f"conftest forced jax_platforms=cpu but got {jax.default_backend()!r}"
)

# Persistent compilation cache: recompiles of the scan kernels dominate test
# wall-clock otherwise.
from multithreading_string_matching.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

REFERENCE_DIR = pathlib.Path(os.environ.get("REFERENCE_DIR", "/root/reference"))


@pytest.fixture(scope="session")
def gpu():
    """JAX's first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (MSM_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/ on the card)")
    return dev


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    if not REFERENCE_DIR.exists():
        pytest.skip("reference fixture directory not available")
    return REFERENCE_DIR


@pytest.fixture(scope="session")
def strings_path(reference_dir):
    return reference_dir / "strings.txt"


@pytest.fixture(scope="session")
def synth_udp(tmp_path_factory):
    """``(pcap path, patterns)``: a seeded 300-packet UDP capture (payloads
    of 160 +- 96 bytes) with occurrences of a seeded 24-entry pattern set
    planted in half of the packets — small enough for quick CPU runs."""
    from multithreading_string_matching.io.synth import (
        synth_patterns,
        synth_udp_pcap,
    )

    pats = synth_patterns(24, max_len=9, seed=5)
    path = tmp_path_factory.mktemp("synth") / "udp.pcap"
    synth_udp_pcap(path, 300, payload_len=160, payload_len_jitter=96,
                   patterns=pats, plant_rate=0.5, seed=5)
    return path, pats
