# conftest.py — hermetic CPU test environment with a virtual 8-device mesh.
import os

# Set before jax is imported.  Without JAX_PLATFORMS the tests run on the
# CPU, with 8 virtual devices so the multi-device sharding paths execute
# without several cards.  The GPU-marked tests run on a card with
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

REFERENCE_SRC = Path("/root/reference/src")
REFERENCE_MG = Path("/root/reference/multigraph_generation")


def has_reference() -> bool:
    return REFERENCE_SRC.exists()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips the test otherwise.  The
    check runs when the test runs, never at collection."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return dev
