# mesh.py — device-mesh data parallelism for batched generation.
"""Multi-device scaling.

The reference scales by forking worker processes over sample indices
(reference src/cli.py:85-129).  Here it is a 1-D device mesh over the
sample axis: per-sample keys are sharded, every pipeline stage is
elementwise over the batch, and the only cross-device communication in the
whole workload is the corpus-dedup all_gather of 8-byte pHashes (NVLink
between the GPUs of one host, all to all), after which every device holds
the global keep-mask.  Images never leave their device until host export.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """1-D mesh over this host's addressable chips.  Local devices only:
    the generators feed host numpy batches and fetch coalesced blobs,
    which requires fully-addressable arrays — a mesh spanning another
    host's chips could neither be fed nor read from here."""
    devs = jax.local_devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """Place a host batch (leading dim divisible by mesh size) onto the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialization.  No-op for a single process.

    The reference has no distributed backend (SURVEY.md §2.3); the
    scale-out here is jax.distributed over several hosts: call this on
    every host before any jax use, then `make_hybrid_mesh()` gives a
    (host, data) mesh whose inner axis stays inside a host (NVLink) and
    whose outer axis crosses the network between hosts.
    """
    if not num_processes or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_hybrid_mesh(host_axis: str = "host", data_axis: str = "data") -> Mesh:
    """2-D (hosts x local chips) mesh.

    Multi-process: rows = processes (between hosts), columns = per-host
    devices, so collectives over `data_axis` never leave a host.  Single-process with
    several devices: devices are folded into a 1 x n mesh so the same
    PartitionSpecs compile (and the CPU test mesh exercises the layout).
    """
    devs = jax.devices()
    n_proc = jax.process_count()
    per_host = len(devs) // max(1, n_proc)
    grid = np.asarray(devs[:n_proc * per_host]).reshape(n_proc, per_host)
    return Mesh(grid, (host_axis, data_axis))


def host_shard_ids(ids, process_index: int | None = None,
                   process_count: int | None = None) -> list:
    """Partition sample ids across hosts for embarrassingly parallel export.

    Each host generates and writes only its strided shard (the dedup
    all_gather still sees every hash, so the keep decisions stay global).
    Deterministic in (id order, process_index) — no coordination needed.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return list(ids)[pi::max(1, pc)]


def _axis_index_flat(axis, mesh: Mesh):
    """Row-major flat shard index over one axis name or a tuple of them."""
    if isinstance(axis, str):
        return jax.lax.axis_index(axis)
    idx = jnp.int32(0)
    for a in axis:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def sharded_dedup_mask(mesh: Mesh, hashes: jnp.ndarray, threshold: int = 4,
                       axis="data", corpus: jnp.ndarray | None = None,
                       corpus_count=None) -> jnp.ndarray:
    """Global dedup keep-mask with hashes sharded over the mesh.

    all_gather of [N/n, 8] u8 hashes between the devices; the greedy pass
    runs replicated (64 bits/sample makes it trivially cheap) and each
    device returns its shard of the mask.

    When `corpus` (a replicated [CAP, 8] buffer with `corpus_count` live
    entries) is given, the batch is additionally deduped against every
    previously-kept hash — the cross-batch corpus filter of
    reference README.md:8, running on-device.

    `axis` may be a tuple of mesh axis names (e.g. ("host", "data") on the
    hybrid mesh) — the gather then crosses hosts and the keep decision is
    global.
    """
    from ..ops.phash import dedup_keep_mask, dedup_keep_mask_vs_corpus

    if corpus is None:
        @partial(jax.shard_map, mesh=mesh, in_specs=P(axis),
                 out_specs=P(axis))
        def _mask(local_hashes):
            all_h = jax.lax.all_gather(local_hashes, axis)
            all_h = all_h.reshape(-1, local_hashes.shape[-1])
            keep = dedup_keep_mask(all_h, threshold=threshold)
            idx = _axis_index_flat(axis, mesh)
            n_local = local_hashes.shape[0]
            return jax.lax.dynamic_slice(keep, (idx * n_local,), (n_local,))

        return _mask(hashes)

    count = jnp.asarray(0 if corpus_count is None else corpus_count,
                        jnp.int32)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis), P(None), P()),
             out_specs=P(axis))
    def _mask_c(local_hashes, corpus_rep, count_rep):
        all_h = jax.lax.all_gather(local_hashes, axis)
        all_h = all_h.reshape(-1, local_hashes.shape[-1])
        keep = dedup_keep_mask_vs_corpus(corpus_rep, count_rep, all_h,
                                         threshold=threshold)
        idx = _axis_index_flat(axis, mesh)
        n_local = local_hashes.shape[0]
        return jax.lax.dynamic_slice(keep, (idx * n_local,), (n_local,))

    return _mask_c(hashes, jnp.asarray(corpus), count)
