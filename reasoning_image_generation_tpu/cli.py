#!/usr/bin/env python3
# cli.py — batch generation front-end (flag-compatible with the reference).
"""CLI for the RPM sequence-puzzle pipeline.

Mirrors reference src/cli.py:36-47 flags:
  --out_dir --n --grid --seed --test --workers --use_threads
plus batching extensions: --batch_size.

`--workers`/`--use_threads` steer the host export pool (the reference used
them for its process fan-out; device generation is batched, so the only
parallel host work left is I/O).  index.json aggregation matches
reference src/cli.py:49-52.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", type=str, default="./out")
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="export-pool threads (default: 8)")
    p.add_argument("--use_threads", action="store_true", default=True,
                   help="kept for reference-flag compatibility (export is "
                        "always thread-pooled unless --workers 0)")
    p.add_argument("--batch_size", type=int, default=32,
                   help="samples per XLA program invocation")
    p.add_argument("--dedup", action="store_true",
                   help="drop near-duplicate samples (on-device pHash)")
    p.add_argument("--dedup_threshold", type=int, default=4)
    p.add_argument("--resume", action="store_true",
                   help="skip sample ids whose meta.json already exists")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="jax.profiler trace output directory")
    p.add_argument("--no_labels", action="store_true",
                   help="omit S0../A-D cell labels on the grids")
    p.add_argument("--no_border", action="store_true",
                   help="omit the 1px cell borders on the grids")
    p.add_argument("--sparse", action="store_true",
                   help="lossless block-sparse device->host transfer codec: "
                        "~2x fewer bytes for ~2x device time; use when the "
                        "device->host link is the bottleneck")
    p.add_argument("--grid_only", action="store_true",
                   help="export only grid_%%06d.png + meta/coco; per-frame "
                        "state/option images never leave the device "
                        "(~9x fewer bytes across the host link)")
    p.add_argument("--pretty_json", action="store_true",
                   help="write meta/coco JSON with indent=2 (the "
                        "reference's byte format); default is compact "
                        "JSON on the C encoder, same content")
    p.add_argument("--no_aot", action="store_true",
                   help="disable the AOT executable cache (utils/aot.py); "
                        "cold starts then re-trace + re-compile each leaf "
                        "pipeline through the XLA persistent cache")
    # multi-host scale-out (the reference scales by forking workers over
    # sample ranges, src/cli.py:85-129; here it is one process per host,
    # each driving its local devices over a strided id shard — see
    # parallel/mesh.py)
    p.add_argument("--num_hosts", type=int, default=1,
                   help="total host processes generating into out_dir; "
                        "this host writes the ids where "
                        "id %% num_hosts == host_id")
    p.add_argument("--host_id", type=int, default=0,
                   help="this host's rank in [0, num_hosts)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="unsupported for this pipeline: hosts run "
                        "independently over disjoint id shards and the "
                        "merge step dedups across hosts via the pHashes "
                        "carried in every meta — no lockstep collective "
                        "is needed.  Passing a coordinator is an error.")
    return p.parse_args(argv)


def write_index(out_dir: str, metas):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.json"), "w", encoding="utf-8") as f:
        json.dump(metas, f, ensure_ascii=False, indent=2)


# persistent XLA compilation cache: the per-leaf pipeline programs compile
# once per machine, not once per process (re-exported for bench.py compat)
from .utils.cache import enable_compilation_cache


def _merge_dedup(metas, dedup_threshold: int,
                 remove_artifacts: bool = True) -> None:
    """Greedy first-wins-by-id pHash dedup across merged metas, vectorized.

    Mirrors the generator's on-device corpus pass
    (ops/phash.dedup_keep_mask): a sample is a duplicate when within
    `dedup_threshold` Hamming bits of any earlier kept sample.  The inner
    test is one numpy xor + popcount against the whole kept matrix
    (bit-parallel via unpackbits on the u8 hash bytes), so a 1e5-sample
    merge is seconds, not hours.  Samples marked duplicate here get their
    already-exported artifacts deleted (in-generator duplicates are never
    exported, so this keeps the on-disk dataset consistent)."""
    cand = [m for m in metas
            if not m.get("duplicate") and not m.get("error")
            and m.get("grid_phash")]
    if not cand:
        return
    hashes = np.stack([np.frombuffer(bytes.fromhex(m["grid_phash"]),
                                     np.uint8) for m in cand])
    kept = np.empty_like(hashes)
    n_kept = 0
    for m, h in zip(cand, hashes):
        if n_kept:
            dist = np.unpackbits(kept[:n_kept] ^ h[None, :],
                                 axis=1).sum(axis=1)
            if int(dist.min()) <= dedup_threshold:
                m["duplicate"] = True
                if remove_artifacts:
                    _remove_sample_artifacts(m)
                continue
        kept[n_kept] = h
        n_kept += 1


def _remove_sample_artifacts(meta: dict) -> None:
    """Delete the exported files of a merge-time duplicate."""
    import shutil
    d = meta.get("sample_dir")
    if d and os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)
    g = meta.get("grid_path")
    if g and os.path.exists(g):
        try:
            os.remove(g)
        except OSError:
            pass


def merge_host_indexes(out_dir: str, dedup_threshold: int | None = None,
                       num_hosts: int | None = None,
                       run_id: str | None = None):
    """Merge per-host index shards (index_hostNN.json) into index.json;
    id-sorted like the reference's single index (reference src/cli.py:49-52).

    Shards are written atomically (temp + os.replace), so a partially
    written file is never visible; a shard that still fails to parse is
    treated as not-yet-present.  With `num_hosts`, the merge only happens
    once ALL shards 0..num_hosts-1 exist (returns None otherwise — the
    last host to finish performs it), and stale shards from a previous run
    with a larger host count are ignored.  With `run_id`, shards stamped
    with a DIFFERENT run id are likewise treated as not-yet-present: a
    fast host rerunning into the same out_dir must not satisfy its merge
    gate with another host's previous-run shard (and then delete fresh
    samples as duplicates of stale hashes).  The CLI derives the id from
    the run parameters, identical across the run's hosts with no
    coordination; an identical rerun reuses the id, which is safe because
    generation is deterministic in (seed, id).

    With `dedup_threshold`, additionally runs the corpus dedup ACROSS
    hosts: every meta carries its grid pHash, so the same greedy
    first-wins-by-id pass the generator applies on-device marks
    cross-host near-duplicates here — deterministic, independent of host
    count, and requiring no lockstep collective between otherwise-
    independent hosts.  Merge-time duplicates get their exported
    artifacts deleted so the on-disk dataset matches the index."""
    import glob
    import re
    shards = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "index_host*.json"))):
        m = re.search(r"index_host(\d+)\.json$", path)
        if not m:
            continue
        rank = int(m.group(1))
        if num_hosts is not None and rank >= num_hosts:
            continue  # stale shard from a previous, larger run
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            shards.pop(rank, None)  # unreadable == not yet present
            continue
        # {"run_id":…, "metas":[…]} (CLI) or a bare meta list (library use)
        shard_run, metas = ((data.get("run_id"), data.get("metas", []))
                            if isinstance(data, dict) else (None, data))
        if run_id is not None and shard_run != run_id:
            continue  # stale shard from a different run
        shards[rank] = metas
    if num_hosts is not None and set(shards) != set(range(num_hosts)):
        return None  # another host will finish later and merge
    metas = [m for rank in sorted(shards) for m in shards[rank]]
    metas.sort(key=lambda m: m.get("id", m.get("index", 0)))
    if dedup_threshold is not None:
        _merge_dedup(metas, dedup_threshold)
    write_index(out_dir, metas)
    return metas


def _run_id(args) -> str:
    """Deterministic id of one multi-host run: every host of the run
    derives the same value from the shared launch parameters, so shard
    stamping needs no cross-host coordination."""
    return (f"seed{args.seed}-n{args.n}-h{args.num_hosts}-g{args.grid}"
            f"-d{args.dedup_threshold if args.dedup else 'off'}"
            f"-{'grid' if args.grid_only else 'full'}")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    enable_compilation_cache()
    if args.coordinator:
        raise SystemExit(
            "--coordinator is not supported: hosts scale out "
            "independently over disjoint id shards "
            "(--num_hosts/--host_id); the merge step dedups across hosts "
            "via the pHash carried in every meta, so no lockstep "
            "collective is needed.")
    from .utils.config import GenConfig
    from .models.rpm.generator import RPMGeneratorTPU

    if args.test:
        # sequential 3-sample smoke test with fixed seed (the reference's
        # --test asserts a stale path layout, src/cli.py:66-70; we assert the
        # layout actually written)
        # batch_size 32 reuses the standard compiled program shapes (a
        # bespoke batch-3 shape would cost a fresh ~minutes compile)
        cfg = GenConfig(out_dir="./out_test", grid_size=3, seed=42,
                        batch_size=32)
        gen = RPMGeneratorTPU(cfg)
        metas = gen.generate(3)
        gen.close()
        for m in metas:
            assert os.path.isdir(m["sample_dir"]), "sample dir missing"
            assert os.path.exists(m["grid_path"]), "grid missing"
            assert os.path.exists(os.path.join(m["sample_dir"], "meta.json"))
            assert os.path.exists(os.path.join(m["sample_dir"], "coco.json"))
        print("Integration test passed, samples in ./out_test")
        return

    cfg = GenConfig(out_dir=args.out_dir, grid_size=args.grid, seed=args.seed,
                    batch_size=args.batch_size,
                    sparse_transfer=args.sparse, grid_only=args.grid_only,
                    aot=not args.no_aot, pretty_json=args.pretty_json)
    workers = args.workers if args.workers is not None else 8
    gen = RPMGeneratorTPU(cfg, io_workers=max(1, workers),
                          use_threads=workers != 0,
                          show_labels=not args.no_labels,
                          show_border=not args.no_border)
    ids = list(range(args.n))
    if args.num_hosts > 1:
        from .parallel.mesh import host_shard_ids
        ids = host_shard_ids(ids, process_index=args.host_id,
                             process_count=args.num_hosts)
        # clear this host's shard from any previous run so the
        # all-shards-present merge gate waits for THIS run's output
        try:
            os.remove(os.path.join(args.out_dir,
                                   f"index_host{args.host_id:02d}.json"))
        except OSError:
            pass
    t0 = time.time()
    print(f"Start generating {len(ids)} samples -> {args.out_dir} "
          f"(batch={args.batch_size}, seed={args.seed})")
    from .utils.profiling import trace
    with trace(args.profile_dir):
        metas = gen.generate_ids(ids, progress=True, dedup=args.dedup,
                                 dedup_threshold=args.dedup_threshold,
                                 resume=args.resume)
    gen.close()
    if args.num_hosts > 1:
        shard_path = os.path.join(args.out_dir,
                                  f"index_host{args.host_id:02d}.json")
        # atomic publish: concurrent mergers never see a torn shard.  The
        # run id stamps the shard so the merge gate can't be satisfied by
        # a previous run's leftover (deterministic from the run params —
        # identical on every host of this run, no coordination needed)
        run_id = _run_id(args)
        tmp = shard_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"run_id": run_id, "metas": metas},
                      f, ensure_ascii=False, indent=2)
        os.replace(tmp, shard_path)
        # only the host that observes the complete shard set merges (the
        # others get None back); the merge itself is idempotent
        merge_host_indexes(args.out_dir,
                           args.dedup_threshold if args.dedup else None,
                           num_hosts=args.num_hosts, run_id=run_id)
    else:
        write_index(args.out_dir, metas)
    dt = time.time() - t0
    print(f"Done. Generated {len(metas)} samples to {args.out_dir} "
          f"in {dt:.2f}s ({len(metas)/dt:.2f} samples/s)")


if __name__ == "__main__":
    main()
