# aot.py — ahead-of-time executable cache (serialize_executable on disk).
"""Snapshot compiled XLA executables so a cold process skips trace+lower+
compile entirely.

The persistent XLA compilation cache (utils/cache.py) already avoids
recompiling known HLO, but every process start still pays per program:
trace the Python (vmap/scan over the whole sample pipeline), lower to
StableHLO, and round-trip the persistent cache.  A production run touches
one big program per rule leaf plus transfer/dedup shapes.  This cache
stores the *compiled executable* itself
(``jax.experimental.serialize_executable``), so a warm start is a file
read + runtime load.

Safety: a stale executable must never load for changed code.  The cache
key folds in

- a sha256 over every ``.py`` source file of this package (so ANY edit to
  the package invalidates every entry),
- ``jax.__version__`` + ``jaxlib.version`` (serialized executables are
  not stable across runtime versions),
- the backend platform, device kind, and process device count,
- the caller's tag (leaf name, canvas, batch size, codec, ... — whatever
  parameterizes the traced program), and
- a fingerprint of the input avals/shardings.

A failed deserialize (corrupt file, runtime refuses the payload) falls
back to a fresh compile and overwrites the entry; ``COUNTS`` records how
many entries loaded, compiled and failed to load, so a caller can tell a
silent recompile from a hit.  Writes are atomic (tempfile + os.replace) so
concurrent processes can share the directory.
"""
from __future__ import annotations

import collections
import hashlib
import logging
import os
import pickle
import threading
from typing import Optional

from .cache import cache_dir

logger = logging.getLogger(__name__)
_PKG_FPRINT: Optional[str] = None
# process-wide tally of cache outcomes: 'loaded', 'compiled', 'load_failed'
COUNTS: collections.Counter = collections.Counter()
_COUNTS_LOCK = threading.Lock()


def _count(event: str) -> None:
    with _COUNTS_LOCK:
        COUNTS[event] += 1


def _package_fingerprint() -> str:
    """sha256 over this package's .py sources (sorted, path-salted)."""
    global _PKG_FPRINT
    if _PKG_FPRINT is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in sorted(os.walk(pkg_root)):
            dirnames.sort()
            if "__pycache__" in dirpath:
                continue
            for fn in sorted(filenames):
                if not fn.endswith((".py", ".c")):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), pkg_root)
                h.update(rel.encode())
                with open(os.path.join(dirpath, fn), "rb") as f:
                    h.update(f.read())
        _PKG_FPRINT = h.hexdigest()[:16]
    return _PKG_FPRINT


def _env_fingerprint() -> str:
    import jax
    import jaxlib

    dev = jax.devices()[0]
    parts = (jax.__version__, jaxlib.version.__version__, dev.platform,
             getattr(dev, "device_kind", "?"), str(jax.device_count()))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _aval_fingerprint(avals) -> str:
    import jax

    def one(a):
        if isinstance(a, jax.ShapeDtypeStruct):
            sh = getattr(a, "sharding", None)
            return f"{a.shape}:{a.dtype}:{sh}"
        return f"{getattr(a, 'shape', '?')}:{getattr(a, 'dtype', type(a))}"

    flat, _ = jax.tree.flatten(avals)
    return hashlib.sha256(
        ";".join(one(a) for a in flat).encode()).hexdigest()[:16]


def aot_dir() -> str:
    return os.path.join(cache_dir(), "aot")


def _entry_path(tag: str, avals) -> str:
    key = hashlib.sha256("|".join((
        tag, _package_fingerprint(), _env_fingerprint(),
        _aval_fingerprint(avals))).encode()).hexdigest()[:32]
    safe_tag = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in tag)[:48]
    return os.path.join(aot_dir(), f"{safe_tag}-{key}.jaxexec")


def load_or_compile(tag: str, jitted, avals,
                    enabled: bool = True, spans_all_devices: bool = False):
    """Return a ``jax.stages.Compiled`` for ``jitted`` at ``avals``.

    ``jitted`` is a ``jax.jit``-wrapped callable; ``avals`` a tuple of
    ``jax.ShapeDtypeStruct`` (or concrete arrays) matching its signature.
    On a cache hit the executable loads without tracing or compiling; on a
    miss it is compiled and persisted.  Returns None if AOT is disabled or
    unusable — callers fall back to plain jit dispatch.

    ``spans_all_devices``: deserialize_and_load loads onto every visible
    device, so with >1 device a single-device executable comes back with
    the wrong device span (measured on the 8-device CPU backend: executing
    it fails with an 8-vs-1 shard mismatch).  The cache is therefore only
    used when one device is visible or when the caller's program is
    compiled across the full device set (mesh-sharded pipelines — those
    round-trip correctly, numpy inputs included).
    """
    if not enabled:
        return None
    import jax
    if (jax.devices()[0].platform == "cpu"
            and not os.environ.get("RIG_AOT_CPU")):
        # XLA:CPU AOT payloads are machine-specific: a payload written on
        # a host with other CPU features loads with machine-feature
        # warnings and can then fail at dispatch with "Function <fusion>
        # not found".  The cache exists to retire the accelerator
        # cold-start; CPU runs keep the persistent HLO cache and plain jit
        # dispatch.  RIG_AOT_CPU=1 overrides (tests pin the round-trip
        # machinery with same-process entries, which are safe).
        return None
    if jax.device_count() > 1 and not spans_all_devices:
        return None
    from jax.experimental import serialize_executable as se

    path = _entry_path(tag, avals)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                payload, in_tree, out_tree = pickle.load(f)
            loaded = se.deserialize_and_load(payload, in_tree, out_tree)
            _probe_execute(loaded, avals)
            _count("loaded")
            return loaded
        except Exception as e:
            _count("load_failed")
            logger.warning("AOT entry %s did not load (%s: %s); "
                           "recompiling", os.path.basename(path),
                           type(e).__name__, e)
            # covers both torn/garbage files and the measured XLA:CPU
            # pathology where a deserialized executable loads fine but
            # dies at dispatch with "Function <fusion> not found" —
            # fall through to a fresh compile and overwrite the entry
            try:
                os.unlink(path)
            except OSError:
                pass
    compiled = jitted.lower(*avals).compile()
    _count("compiled")
    os.makedirs(aot_dir(), exist_ok=True)
    blob = pickle.dumps(se.serialize(compiled))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return compiled


def _probe_execute(loaded, avals) -> None:
    """Execute the deserialized executable once on zero-filled inputs and
    block on the result.  Deserialization can SUCCEED and then fail at
    dispatch ("Buffer Definition Event: Function <fusion> not found",
    measured on the 8-device CPU backend depending on what else the
    process compiled first) — a cheap probe call surfaces that here so
    the caller falls back to a fresh compile instead of a run-time crash.
    All pipeline programs are pure, so a zero-input call has no effects;
    its cost (one tiny dispatch) is noise next to the trace+compile the
    cache exists to skip."""
    import jax
    import numpy as np

    try:
        in_sh = loaded.input_shardings[0]
    except Exception:
        in_sh = jax.tree.map(lambda a: getattr(a, "sharding", None),
                             tuple(avals))

    def zero(a, s):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            # typed PRNG keys (the pipelines' per-sample keys) have no
            # numpy dtype; any valid key of the same shape will do
            arr = jax.numpy.broadcast_to(jax.random.key(0), a.shape)
        else:
            arr = np.zeros(a.shape, a.dtype)
        return jax.device_put(arr, s) if s is not None else arr

    args = jax.tree.map(zero, tuple(avals), tuple(in_sh))
    jax.block_until_ready(loaded(*args))


def clear() -> int:
    """Delete every AOT entry; returns the number removed."""
    n = 0
    try:
        for fn in os.listdir(aot_dir()):
            if fn.endswith(".jaxexec"):
                os.unlink(os.path.join(aot_dir(), fn))
                n += 1
    except OSError:
        pass
    return n
