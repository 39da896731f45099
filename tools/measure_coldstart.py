#!/usr/bin/env python
# measure_coldstart.py — time a FRESH process from exec to first-batch-ready,
# with and without the AOT executable cache (utils/aot.py).
#
# Three configurations, each in its own subprocess (cold jit caches):
#   nocache : AOT entries cleared, --no_aot      -> trace + lower + XLA
#             persistent-cache lookup per program (the pre-AOT cold start;
#             a truly cold machine additionally compiles every program)
#   aotcold : AOT entries cleared, AOT on        -> same, plus serialize
#   aotwarm : AOT entries present, AOT on        -> deserialize only
#
# Reports JSON {config: seconds} for N leaves x one batch size.
#
# Usage: python tools/measure_coldstart.py [--leaves 9] [--batch_size 32]
#        [--grid_only] [--mg]
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD_RPM = r"""
import sys, time, numpy as np
t0 = time.time()
sys.path.insert(0, {repo!r})
from reasoning_image_generation_tpu.utils.config import GenConfig, RULE_LEAVES
from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
import tempfile, shutil
out = tempfile.mkdtemp(prefix="rig_cold_")
leaves = RULE_LEAVES[: {n_leaves}]
cfg = GenConfig(out_dir=out, seed=0, batch_size={batch_size},
                aot={aot}, category_weights={{l: 1.0 for l in leaves}})
cfg.grid_only = {grid_only}
gen = RPMGeneratorTPU(cfg)
ids = list(range({batch_size} * max(12, len(leaves))))
gen.warmup(ids)
print("READY", time.time() - t0, flush=True)
gen.close(); shutil.rmtree(out, ignore_errors=True)
"""

CHILD_MG = r"""
import sys, time
t0 = time.time()
sys.path.insert(0, {repo!r})
from reasoning_image_generation_tpu.models.multigraph.generator import (
    GeometryGeneratorTPU)
from reasoning_image_generation_tpu.models.multigraph.scene import (
    build_scene_batch)
import numpy as np
gen = GeometryGeneratorTPU(io_workers=1, aot={aot})
n = {batch_size}
modes = (["nested", "adjacent", "intersecting", "random"] * n)[:n]
batch, _ = build_scene_batch(list(range(n)), modes, 1.3)
st = gen._render_dispatch(batch, dpi={dpi})
np.asarray(st["blob"])
print("READY", time.time() - t0, flush=True)
gen.close()
"""


def run_child(code: str) -> float:
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=7200)
    if "READY" not in r.stdout:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-4000:])
        raise RuntimeError("child failed")
    # child-reported time excludes interpreter start; report wall anyway
    return time.time() - t0


def clear_aot() -> int:
    sys.path.insert(0, REPO)
    from reasoning_image_generation_tpu.utils.aot import clear
    return clear()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=9)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--grid_only", action="store_true")
    ap.add_argument("--mg", action="store_true",
                    help="measure the multigraph renderer instead")
    ap.add_argument("--dpi", type=int, default=200)
    ap.add_argument("--skip_nocache", action="store_true")
    args = ap.parse_args()

    if args.mg:
        child = lambda aot: CHILD_MG.format(
            repo=REPO, aot=aot, batch_size=args.batch_size, dpi=args.dpi)
    else:
        child = lambda aot: CHILD_RPM.format(
            repo=REPO, aot=aot, n_leaves=args.leaves,
            batch_size=args.batch_size, grid_only=args.grid_only)

    res = {}
    if not args.skip_nocache:
        clear_aot()
        res["nocache_s"] = round(run_child(child(False)), 2)
    clear_aot()
    res["aotcold_s"] = round(run_child(child(True)), 2)
    res["aotwarm_s"] = round(run_child(child(True)), 2)
    res["aotwarm2_s"] = round(run_child(child(True)), 2)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
