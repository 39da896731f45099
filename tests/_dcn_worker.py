# _dcn_worker.py — subprocess body for the multi-process smoke test.
"""Run as `python tests/_dcn_worker.py <pid> <nproc> <port>` with
XLA_FLAGS=--xla_force_host_platform_device_count=2 in the environment.

Exercises the real multi-host path of parallel/mesh.py over jax.distributed
with two local CPU processes (network = loopback TCP, collectives = gloo):
`distributed_init` -> `make_hybrid_mesh` -> `host_shard_ids` ->
`sharded_dedup_mask` over the ("host", "data") axes, i.e. a keep decision
that crosses process boundaries.  Prints one JSON line the parent asserts on.

The reference has no distributed backend at all (SURVEY.md §2.3) — its
scale-out is fork-per-sample-range (reference src/cli.py:85-129); this is
the device-mesh replacement's correctness evidence.
"""
import json
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax
    # Order matters: platform + collective backend must be set before the
    # distributed service touches any XLA client.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from reasoning_image_generation_tpu.parallel.mesh import (
        distributed_init, make_hybrid_mesh, host_shard_ids,
        sharded_dedup_mask)

    distributed_init(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_hybrid_mesh()
    assert dict(mesh.shape) == {"host": nproc, "data": 2}, mesh.shape
    # each mesh row must be process-pure, else "data" collectives cross hosts
    for row in np.asarray(mesh.devices):
        owners = {d.process_index for d in row}
        assert len(owners) == 1, f"mixed-process mesh row: {owners}"

    shard = host_shard_ids(range(8))

    # 8 global hashes, 4 per process.  Index 5 duplicates index 1 (a
    # cross-host duplicate: 1 lives on proc 0, 5 on proc 1) and index 2
    # is present in the corpus — the global mask must drop both.
    rng = np.random.default_rng(0)
    full = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    full[5] = full[1]
    local = full[pid * 4:(pid + 1) * 4]

    sharding = NamedSharding(mesh, P(("host", "data")))
    hashes = jax.make_array_from_process_local_data(sharding, local, (8, 8))

    mask = sharded_dedup_mask(mesh, hashes, threshold=4,
                              axis=("host", "data"))
    local_mask = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(mask.addressable_shards, key=lambda s: s.index[0].start)])

    corpus = np.zeros((16, 8), np.uint8)
    corpus[0] = full[2]
    mask_c = sharded_dedup_mask(mesh, hashes, threshold=4,
                                axis=("host", "data"),
                                corpus=corpus, corpus_count=1)
    local_mask_c = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(mask_c.addressable_shards, key=lambda s: s.index[0].start)])

    print("DCN_RESULT " + json.dumps({
        "pid": pid,
        "shard_ids": list(shard),
        "mask": local_mask.astype(int).tolist(),
        "mask_corpus": local_mask_c.astype(int).tolist(),
    }), flush=True)


if __name__ == "__main__":
    main()
