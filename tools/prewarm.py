#!/usr/bin/env python
# prewarm.py — bake every production program shape into the persistent
# XLA compilation cache (utils/cache.py: $JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache).
#
# Every per-leaf pipeline program compiles on a cold machine; the
# persistent cache loads them in seconds.
# Run this once per deployment image (or ship the cache directory with
# it) and a cold `python -m reasoning_image_generation_tpu.cli --n 1000`
# waits seconds, not an hour, before its first batch.
#
# Coverage: all 9 RPM rule leaves x {full, grid_only} on the REAL
# generate_ids path (render + pack + coalesce + dedup + pHash programs,
# at the frozen transfer tiers a production run uses), plus the
# multigraph renderer + its pack/coalesce shapes at dpi 200.
#
# Usage: python tools/prewarm.py [--batch_size 32] [--canvas 512x512]
#        [--dpi 200] [--skip_mg] [--skip_rpm]
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def prewarm_rpm(batch_size: int, canvas, grid_only: bool,
                sparse_transfer: bool = False) -> None:
    from reasoning_image_generation_tpu.models.rpm.generator import (
        RPMGeneratorTPU)
    from reasoning_image_generation_tpu.utils.config import (
        GenConfig, RULE_LEAVES)

    out = tempfile.mkdtemp(prefix="rig_prewarm_")
    try:
        cfg = GenConfig(out_dir=out, canvas_size=canvas, seed=0,
                        batch_size=batch_size,
                        sparse_transfer=sparse_transfer,
                        # every leaf compiles: uniform weights
                        category_weights={l: 1.0 for l in RULE_LEAVES})
        cfg.grid_only = grid_only
        gen = RPMGeneratorTPU(cfg)
        # enough ids that the weighted assignment covers all 9 leaves
        ids = list(range(batch_size * 12))
        t0 = time.time()
        gen.warmup(ids)
        tag = ("grid_only" if grid_only else "full") + \
            ("+sparse" if sparse_transfer else "")
        print(f"rpm leaf pipelines ({tag}): "
              f"{time.time() - t0:.1f}s", flush=True)
        # real path: transfer pack/coalesce + corpus dedup + export programs
        t0 = time.time()
        gen.generate_ids(ids[: batch_size * 2], dedup=True)
        gen.close()
        print(f"rpm transfer/dedup/export programs: "
              f"{time.time() - t0:.1f}s", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def prewarm_mg(dpi: int, batch_size: int, dedup: bool = False) -> None:
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)

    out = tempfile.mkdtemp(prefix="rig_prewarm_mg_")
    try:
        gen = GeometryGeneratorTPU()
        n = batch_size * 2
        modes = [["adjacent", "nested", "intersecting", "random"][i % 4]
                 for i in range(n)]
        t0 = time.time()
        gen.generate_batches(
            seeds=list(range(n)),
            modes=modes,
            save_paths=[os.path.join(out, f"{i}_{m}.png")
                        for i, m in enumerate(modes)],
            dpi=dpi, batch_size=batch_size, dedup=dedup)
        gen.close()
        print(f"mg renderer + transfer programs (B={batch_size}, "
              f"dedup={dedup}): {time.time() - t0:.1f}s", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--canvas", type=str, default="512x512")
    p.add_argument("--dpi", type=int, default=200)
    p.add_argument("--mg_batch_size", type=int, default=16)
    p.add_argument("--skip_mg", action="store_true")
    p.add_argument("--skip_rpm", action="store_true")
    args = p.parse_args()

    from reasoning_image_generation_tpu.utils.cache import (
        enable_compilation_cache, cache_dir)
    enable_compilation_cache()
    print(f"prewarming into {cache_dir()}", flush=True)

    W, H = (int(x) for x in args.canvas.split("x"))
    t0 = time.time()
    if not args.skip_rpm:
        # the three production/bench configs: device-rate (dense),
        # grid-only export (sparse codec), full export (sparse codec)
        prewarm_rpm(args.batch_size, (W, H), grid_only=False)
        prewarm_rpm(args.batch_size, (W, H), grid_only=True,
                    sparse_transfer=True)
        prewarm_rpm(args.batch_size, (W, H), grid_only=False,
                    sparse_transfer=True)
    if not args.skip_mg:
        # CLI default batch plus the bench's rate (8) / combined-dataset
        # (50) batch shapes, with the corpus-dedup program
        prewarm_mg(args.dpi, args.mg_batch_size, dedup=True)
        for b in (8, 50):
            if b != args.mg_batch_size:
                prewarm_mg(args.dpi, b, dedup=True)
    n = sum(len(files) for _, _, files in os.walk(cache_dir()))
    print(f"done in {time.time() - t0:.1f}s; cache now holds {n} entries",
          flush=True)


if __name__ == "__main__":
    main()
