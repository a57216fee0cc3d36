"""Test configuration: JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); sharding is checked on
virtual host devices and the GPU decode kernel in Pallas interpret mode.
Checks that need the card are phases of ``chip_smoke.py`` or tests marked
``gpu``, which skip here (see the ``gpu_device`` fixture).
"""

import os
import subprocess
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
_HARNESS_SRC = REPO / "tests" / "cross_check" / "ref_codec_harness.cpp"
_HARNESS_BIN = REPO / "tests" / "cross_check" / "ref_codec_harness"


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: decided here, at run time, never while
    a test module is imported."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]


@pytest.fixture(scope="session")
def ref_codec_harness():
    """Path to the compiled reference-codec harness, or skip if the read-only
    reference checkout is unavailable."""
    if not REFERENCE.exists():
        pytest.skip("reference checkout not available")
    if not _HARNESS_BIN.exists() or _HARNESS_BIN.stat().st_mtime < _HARNESS_SRC.stat().st_mtime:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17",
                f"-I{REFERENCE}",
                str(_HARNESS_SRC),
                str(REFERENCE / "custom_invlist_cpp" / "codec.cpp"),
                "-o", str(_HARNESS_BIN),
            ],
            check=True,
        )
    return _HARNESS_BIN
