# cache.py — persistent XLA compilation cache and the caches beside it.
"""Where compiled programs and run statistics are kept on disk.

Every leaf pipeline is one large XLA program, so a cold process spends most
of its start-up compiling.  The persistent compilation cache makes a
previously compiled program load in seconds; both generators enable it at
construction (the CLIs earlier still), so library users get it without
knowing the knob exists.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache directory: JAX reads
it itself and this module sets no other.  Otherwise the cache lives at a
fixed path inside the checkout, ``<repo>/.jax_cache`` (gitignored): the
path is part of what makes a later process find the entries again.  The
AOT executables (utils/aot.py) and the run statistics live under the same
root.
"""
from __future__ import annotations

import json
import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    return os.path.join(_REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """Root of the on-disk caches: $JAX_COMPILATION_CACHE_DIR if set, else
    ``<repo>/.jax_cache``."""
    return os.environ.get(_ENV) or default_cache_dir()


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent)."""
    import jax
    if not os.environ.get(_ENV) and not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def _stats_path(name: str) -> str:
    return os.path.join(cache_dir(), f"runstats_{name}.json")


def load_run_stats(name: str) -> dict:
    """Persisted transfer-tier statistics (largest run count per packed
    tensor, io/transfer.py::transfer_tier), so a fresh process starts with
    converged tiers.  A missing or unreadable file is an empty record
    (the statistics only size buffers; a later save rewrites the file)."""
    try:
        with open(_stats_path(name), encoding="utf-8") as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}
    # floats, not int(): rle3 stats are per-frame AVERAGES; truncation
    # would restart persisted tiers slightly below the observed value
    return {str(k): float(v) for k, v in data.items()}


def save_run_stats(name: str, stats: dict) -> None:
    """Max-merge `stats` into the persisted file (atomic replace)."""
    if not stats:
        return
    merged = load_run_stats(name)
    for k, v in stats.items():
        merged[k] = max(float(v), merged.get(k, 0.0))
    path = _stats_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(merged, f)
    os.replace(tmp, path)
