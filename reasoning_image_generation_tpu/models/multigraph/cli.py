# cli.py — multigraph batch front-end (mirrors multigraph_generation/cli.py).
"""Generates the single-image dataset.

Mirrors the reference driver (multigraph_generation/cli.py:30-72): 100
samples, global_scale=1.3, dpi=200, outputs output/images/{i}_{mode}.png +
output/params/{i}_{mode}.json, per-sample seed=i.  The mode distribution
follows the reference as committed (hardcoded to 'adjacent',
multigraph_generation/cli.py:42); pass --modes to use the commented-out full
choice (random|nested|adjacent|intersecting).
"""
from __future__ import annotations

import argparse
import random
import time


def generate_all(num_samples: int = 100, out_dir: str = "output",
                 global_scale: float = 1.3, dpi: int = 200,
                 mode_choices=("adjacent",), batch_size: int = 16,
                 seed0: int = 0, use_multiprocessing: bool = True):
    # use_multiprocessing is accepted for reference-signature compatibility
    # (multigraph_generation/cli.py:30); device batching supersedes it
    del use_multiprocessing
    from .generator import GeometryGeneratorTPU

    # pre-sample modes like the reference (multigraph_generation/cli.py:41-42)
    modes = [random.choice(list(mode_choices)) for _ in range(num_samples)]
    gen = GeometryGeneratorTPU(global_scale=global_scale)
    t0 = time.time()
    # software-pipelined driver: batch k+1 renders on device while batch
    # k's QC/export runs on host (generator.generate_batches)
    gen.generate_batches(
        seeds=[seed0 + i for i in range(num_samples)],
        modes=modes,
        save_paths=[f"{out_dir}/images/{i}_{modes[i]}.png"
                    for i in range(num_samples)],
        params_save_paths=[f"{out_dir}/params/{i}_{modes[i]}.json"
                           for i in range(num_samples)],
        dpi=dpi, batch_size=batch_size,
        progress=lambda done: print(f"生成完成：{done}/{num_samples}"))
    gen.close()
    dt = time.time() - t0
    print(f"所有生成任务完成 ({num_samples} samples in {dt:.2f}s, "
          f"{num_samples / dt:.2f}/s)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--global_scale", type=float, default=1.3)
    p.add_argument("--dpi", type=int, default=200)
    p.add_argument("--modes", type=str, default="adjacent",
                   help="comma list: random,nested,adjacent,intersecting")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from ...utils.cache import enable_compilation_cache
    enable_compilation_cache()
    generate_all(args.n, args.out_dir, args.global_scale, args.dpi,
                 tuple(args.modes.split(",")), args.batch_size, args.seed)


if __name__ == "__main__":
    main()
