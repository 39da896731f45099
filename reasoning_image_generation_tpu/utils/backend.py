# utils/backend.py — device lookup and renderer dispatch.
"""Which devices JAX runs on, and which renderer they get.

JAX picks its platform itself (``JAX_PLATFORMS`` selects one); this module
only reads the answer.  The RPM render kernel is written for the GPU
(Pallas, Triton route); the CPU, which runs the tests, takes the plain
``jax.numpy`` renderer.  Any other platform is an error rather than a
silent fallback to the slow path.
"""
from __future__ import annotations


def devices_or_raise():
    """``jax.devices()``; a backend that fails to start raises."""
    import jax
    return jax.devices()


def detect_platform() -> str:
    """Platform of the default backend: 'gpu' or 'cpu' (or another name
    JAX reports, which ``auto_renderer`` refuses)."""
    return devices_or_raise()[0].platform.lower()


def auto_renderer(platform: str | None = None) -> str:
    """Renderer for ``renderer='auto'``: the GPU kernel on 'gpu', the jnp
    path on 'cpu'; any other platform raises."""
    platform = detect_platform() if platform is None else platform
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "jnp"
    raise RuntimeError(
        f"no renderer for platform {platform!r}: the kernels target the GPU "
        "and the jnp path the CPU; pass renderer='jnp' to force the plain "
        "path")
