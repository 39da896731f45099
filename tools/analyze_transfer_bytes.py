#!/usr/bin/env python3
# analyze_transfer_bytes.py — per-key byte composition of one batch's
# device->host transfer blob, after tier shrinking.  Run on CPU
# (JAX_PLATFORMS=cpu) to decide which stream to attack next; bytes are
# platform-invariant.
from __future__ import annotations

import os
import sys
import tempfile

# Bootstrap the repo root so the script runs from any directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from reasoning_image_generation_tpu.utils.config import GenConfig
from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
from reasoning_image_generation_tpu.models.rpm.pipeline import sample_keys
from reasoning_image_generation_tpu.io.transfer import shrunk_specs, blob_specs


def main(grid_only: bool = True) -> None:
    out_dir = tempfile.mkdtemp()
    cfg = GenConfig(out_dir=out_dir, seed=123, batch_size=32,
                    sparse_transfer=True, grid_only=grid_only)
    for a in sys.argv[1:]:
        if a.startswith("--codec="):
            cfg.transfer_codec = a.split("=", 1)[1]
    gen = RPMGeneratorTPU(cfg)
    gen.generate_ids(list(range(96)))        # warm: tiers converge
    gen.generate_ids(list(range(96, 192)))
    groups = gen._sample_assignments(list(range(192, 320)))
    codec = getattr(cfg, "transfer_codec", "rle2")
    print("codec:", codec, "grid_only:", grid_only)
    for leaf, entries in groups.items():
        chunk = entries[:32]
        if len(chunk) < 8:
            continue
        pipe = gen._pipeline(leaf)
        pad = [e[0] for e in chunk] + [chunk[0][0]] * (32 - len(chunk))
        ug = np.asarray([e[2] for e in chunk] + [False] * (32 - len(chunk)))
        o = pipe(sample_keys(123, np.asarray(pad)), ug)
        skip = set()
        if "state_imgs_packed" in o:
            skip |= {"state_imgs", "option_imgs"}
        if "grid_img_packed" in o:
            skip |= {"grid_img"}
        transfer = {k: v for k, v in o.items() if k not in skip}
        if codec.startswith(("rle3", "rle4", "rle5")):
            # mirror generator.generate_ids' device compaction exactly
            from reasoning_image_generation_tpu.ops import rle as _r
            # same lookup the generator uses (models/rpm/generator.py,
            # _COMPACT_CODECS path) so the tool accepts exactly the codec
            # set the generator does
            base = codec.rstrip("d")
            c_plain = getattr(_r, f"compact_{base}")
            c_delta = getattr(_r, f"compact_{base}d")
            for key in list(transfer):
                if key.endswith("_packed"):
                    val = transfer[key]
                    transfer[key] = (c_delta(*val) if len(val) == 4
                                     else c_plain(*val))
        leaves, treedef, specs = blob_specs(transfer)
        sizes = gen._shrink_sizes(leaf, transfer)
        specs2 = shrunk_specs(leaves, sizes)
        flat_keys = []
        for k in sorted(transfer):
            n = len(jax.tree.leaves(transfer[k]))
            flat_keys += [f"{k}[{i}]" for i in range(n)]
        print(f"--- leaf {leaf} (batch 32) ---")
        tot = 0
        for fk, (shape, dt) in zip(flat_keys, specs2):
            nb = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            tot += nb
            print(f"{fk:38s} {str(shape):26s} {str(dt):8s} "
                  f"{nb:9d} B {nb / 32:8.0f} B/sample")
        print(f"TOTAL {tot} B -> {tot / 32:.0f} B/sample")
    gen.close()


if __name__ == "__main__":
    main(grid_only="--full" not in sys.argv)
