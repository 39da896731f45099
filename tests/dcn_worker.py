# dcn_worker.py — subprocess body for the multi-process smoke test.
"""Launched by tests/test_distributed.py (2 processes x 4 CPU devices).
Exercises distributed_init + make_hybrid_mesh + host_shard_ids +
a process-crossing global dedup decision; prints one JSON result line."""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

# the config API pins the platform before backend init whatever the
# environment says.  CPU cross-process collectives need the Gloo
# implementation.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from reasoning_image_generation_tpu.parallel.mesh import (  # noqa: E402
    distributed_init, host_shard_ids, make_hybrid_mesh, sharded_dedup_mask)


def main():
    coord = sys.argv[1]
    pid = int(sys.argv[2])
    nproc = int(sys.argv[3])
    distributed_init(coordinator_address=coord, num_processes=nproc,
                     process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    mesh = make_hybrid_mesh()
    assert mesh.devices.shape == (nproc, 4), mesh.devices.shape

    # disjoint export shards
    ids = list(range(10))
    mine = host_shard_ids(ids)

    # global dedup across processes: a deterministic global hash table with two
    # planted near-duplicate pairs, sharded (host, data); every process
    # must come back with the same global keep decision for its rows.
    rng = np.random.RandomState(0)
    global_hashes = rng.randint(0, 256, size=(16, 8)).astype(np.uint8)
    global_hashes[9] = global_hashes[2]          # dup across hosts
    global_hashes[13] = global_hashes[12]        # dup within a host
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(("host", "data")))
    arr = jax.make_array_from_callback(
        (16, 8), sharding, lambda idx: global_hashes[idx])
    keep = sharded_dedup_mask(mesh, arr, threshold=4, axis=("host", "data"))
    local_keep = [np.asarray(s.data).tolist()
                  for s in keep.addressable_shards]
    local_idx = [s.index[0] for s in keep.addressable_shards]
    local = sorted(zip([i.start for i in local_idx], local_keep))
    print(json.dumps({
        "pid": pid,
        "process_count": jax.process_count(),
        "mine": mine,
        "keep_shards": local,
    }), flush=True)


if __name__ == "__main__":
    main()
