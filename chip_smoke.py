#!/usr/bin/env python3
"""Smoke test of both pipelines on one NVIDIA GPU (or a four-GPU mesh).

    python chip_smoke.py          # phases 0-4 on one GPU
    python chip_smoke.py --four   # mesh of four GPUs against one GPU

Phases (any failure exits non-zero; the last stdout line is a JSON record
only when every phase passed):

0. device: a GPU is the default device; card, versions, cache, encoder.
1. kernel: the RPM render kernel compiled at real widths and compared
   with the plain jnp renderer on the card (max |diff| <= 1 u8 level).
2. kernel against XLA: kernel and plain renderer timed at the pipeline's
   shapes, then the RPM leaf step end to end with each; the multigraph
   render and batch (plain path) timed for the record.
3. main path: the RPM CLI (1024 samples, 512^2, dedup, full export) and
   the multigraph CLI (100 images, dpi 200, all modes); AOT cache reload.
4. GPU against CPU: 64 RPM samples on both; grids and pHashes compared.

One process drives every card; run no other JAX process beside it.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LEAF4 = "平移"        # L=4: 4 states + 4 options = 8 frames
LEAF6 = "直接叠加"    # L=6 overlay leaf: 10 frames
MG_MODES = ("random", "nested", "adjacent", "intersecting")


def log(msg: str) -> None:
    print(msg, flush=True)


def bench(fn, *args, reps: int = 5) -> float:
    """Median seconds of fn(*args) after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def compare_u8(name: str, got, ref, tol: int = 1) -> None:
    got = np.asarray(got).astype(np.int16)
    ref = np.asarray(ref).astype(np.int16)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    d = np.abs(got - ref)
    log(f"  {name}: shape {got.shape} max|diff| {int(d.max())} "
        f"differing pixels {int((d > 0).any(-1).sum())} of "
        f"{d[..., 0].size}")
    if int(d.max()) > tol:
        raise AssertionError(f"{name}: max |diff| {int(d.max())} > {tol}")


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} "
                     f"{getattr(m, f, 0) / 2**20:.1f} MiB" for f in fields)


# ---------------------------------------------------------------- phase 0
def phase0_device(n_expected: int) -> dict:
    import jax
    import jaxlib
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: default device is {devs[0].platform}")
    if len(devs) < n_expected:
        raise RuntimeError(f"need {n_expected} GPUs, JAX sees {len(devs)}")
    log(f"device: {devs[0].device_kind} x{len(devs)} "
        f"(platform {devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax {jax.__version__} jaxlib {jaxlib.version.__version__}")
    from reasoning_image_generation_tpu.utils.cache import (
        cache_dir, enable_compilation_cache)
    enable_compilation_cache()
    log(f"compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(program cache root {cache_dir()})")
    from reasoning_image_generation_tpu.io import png
    enc = png.backend_name()
    log(f"PNG encoder: {enc}")
    if enc != "fastpng":
        raise RuntimeError(f"the C PNG encoder did not build (got {enc})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------- phase 1
def _elem(kind, size, center, angle=30.0, color=(40, 80, 200), fill=True,
          stroke=2):
    return {"kind": kind, "size": size, "fill": fill, "stroke_width": stroke,
            "center": center, "angle": angle, "bbox": (0, 0, size, size),
            "flip": {"h": False, "v": False}, "color": color}


def rpm_test_frames(W: int, H: int):
    """One frame per shape kind, each with a wrap-around partner on a
    canvas edge and a third element; grid snap alternates on and off."""
    import jax
    import jax.numpy as jnp
    from reasoning_image_generation_tpu.utils.config import SHAPE_KINDS
    from reasoning_image_generation_tpu.utils.state import dicts_to_state
    states = []
    for k, kind in enumerate(SHAPE_KINDS):
        other = SHAPE_KINDS[(k + 5) % len(SHAPE_KINDS)]
        els = [_elem(kind, 0.28 * min(W, H), (0.5 * W, 0.5 * H), 15.0 * k,
                     stroke=1 + k % 3),
               _elem(other, 0.2 * min(W, H), (W - 10.0, 0.3 * H), 40.0,
                     color=(200, 30, 30), fill=k % 2 == 0),
               _elem(kind, 0.15 * min(W, H), (0.2 * W, H - 5.0), 0.0,
                     color=(30, 160, 60))]
        states.append(dicts_to_state(els, 8))
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    ug = np.arange(len(states)) % 2 == 1
    return batch, ug


def phase1_kernels() -> None:
    import jax
    from reasoning_image_generation_tpu.ops.raster import render_batch
    from reasoning_image_generation_tpu.ops.raster_pallas import (
        render_batch_pallas)
    for W, H in ((512, 512), (600, 200)):
        batch, ug = rpm_test_frames(W, H)
        t0 = time.perf_counter()
        got = jax.block_until_ready(render_batch_pallas(batch, W, H, ug))
        log(f"rpm kernel {W}x{H}: compiled+ran in "
            f"{time.perf_counter() - t0:.1f}s")
        compare_u8(f"rpm kernel vs jnp {W}x{H} (11 kinds, grid on/off, wrap)",
                   got, render_batch(batch, W, H, ug))


# ---------------------------------------------------------------- phase 2
def rpm_frames(leaf: str, B: int = 32, seed: int = 0):
    """Realistic frames of one leaf: B samples x F frames, flattened."""
    import jax
    import jax.numpy as jnp
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        make_sample_fn, sample_keys)
    cfg = GenConfig(seed=seed)
    keys = sample_keys(seed, np.arange(B))
    ug = np.arange(B) % 2 == 0
    out = jax.jit(jax.vmap(make_sample_fn(leaf, cfg)))(keys, ug)
    fr = out["rframes"]
    F = fr.kind.shape[1]
    flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), fr)
    return flat, jnp.repeat(jnp.asarray(ug), F), F


def _plain_rpm_map(states, use_grid, F: int, W: int = 512, H: int = 512):
    """The pipeline's plain path: frames one at a time, batch in parallel."""
    import jax
    from reasoning_image_generation_tpu.ops.raster import render_frame
    B = use_grid.shape[0] // F
    st = jax.tree.map(lambda a: a.reshape((B, F) + a.shape[1:]), states)
    st = jax.tree.map(lambda a: a.swapaxes(0, 1), st)
    ug = use_grid.reshape(B, F)[:, 0]
    imgs = jax.lax.map(lambda fb: jax.vmap(
        lambda s, g: render_frame(s, W, H, use_grid=g))(fb, ug), st)
    return imgs.swapaxes(0, 1).reshape((B * F,) + imgs.shape[2:])


def phase2_timing() -> None:
    import jax
    from functools import partial
    from reasoning_image_generation_tpu.ops.raster import render_batch
    from reasoning_image_generation_tpu.ops.raster_pallas import (
        render_batch_pallas)
    from reasoning_image_generation_tpu.models.multigraph.renderer import (
        render_scene_batch)
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        build_scene_batch)
    for leaf in (LEAF4, LEAF6):
        states, ug, F = rpm_frames(leaf)
        mapped = jax.jit(partial(_plain_rpm_map, F=F))
        t_k = bench(lambda s, g: render_batch_pallas(s, 512, 512, g),
                    states, ug)
        t_v = bench(lambda s, g: render_batch(s, 512, 512, g), states, ug)
        t_m = bench(mapped, states, ug)
        n = int(ug.shape[0])
        log(f"rpm render {leaf} 32x{F}={n} frames 512^2: kernel "
            f"{t_k * 1e3:.2f} ms, XLA vmap {t_v * 1e3:.2f} ms, XLA lax.map "
            f"{t_m * 1e3:.2f} ms (kernel {min(t_v, t_m) / t_k:.1f}x the "
            f"better plain)")
    for B in (16, 50):
        modes = [MG_MODES[i % 4] for i in range(B)]
        scenes, _ = build_scene_batch(list(range(B)), modes, 1.3)
        plain = jax.jit(partial(render_scene_batch, dpi=200))
        compiled = plain.lower(scenes).compile()
        t_p = bench(compiled, scenes)
        log(f"mg render B={B} dpi 200 (XLA): {t_p * 1e3:.2f} ms; memory "
            f"{memory_line(compiled)}")


def phase2_end_to_end() -> None:
    """The RPM leaf step and the multigraph batch, each renderer."""
    import jax
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        LeafPipeline, sample_keys)
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    keys = sample_keys(0, np.arange(32))
    ug = np.arange(32) % 2 == 0
    for leaf in (LEAF4, LEAF6):
        times = {}
        for renderer in ("pallas", "jnp"):
            pipe = LeafPipeline(leaf, GenConfig(seed=0, renderer=renderer,
                                                aot=False))
            t0 = time.perf_counter()
            compiled = pipe._batch_fn.lower(keys, ug).compile()
            t_c = time.perf_counter() - t0
            if renderer == "pallas":
                log(f"rpm leaf step {leaf} B=32: memory "
                    f"{memory_line(compiled)}")
            times[renderer] = bench(compiled, keys, ug)
            log(f"rpm leaf step {leaf} B=32 renderer={renderer}: compile "
                f"{t_c:.1f}s, step {times[renderer] * 1e3:.2f} ms "
                f"({32 / times[renderer]:.0f} samples/s)")
        log(f"  leaf step {leaf}: kernel {times['jnp'] / times['pallas']:.2f}x"
            " the plain path")
    seeds = list(range(64))
    modes = [MG_MODES[i % 4] for i in seeds]
    gen = GeometryGeneratorTPU(aot=False)
    # two untimed passes: the first converges the transfer tiers, the
    # second compiles the programs of the converged shapes
    for _ in range(2):
        gen.generate_batches(seeds, modes, dpi=200, batch_size=16)
    t0 = time.perf_counter()
    gen.generate_batches(seeds, modes, dpi=200, batch_size=16)
    gen._pool.drain()
    dt = time.perf_counter() - t0
    gen.close()
    log(f"mg batch end to end: 64 images dpi 200 B=16 in {dt:.2f}s "
        f"({64 / dt:.1f} images/s, no files)")


# ---------------------------------------------------------------- phase 3
def _read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _png_bytes(d):
    return {os.path.relpath(p, d): open(p, "rb").read()
            for p in glob.glob(os.path.join(d, "**", "*.png"),
                               recursive=True)}


def phase3_main_path(root: str, n: int = 1024, batch: int = 32,
                     mg_n: int = 100, dpi: int = 200) -> None:
    from reasoning_image_generation_tpu import cli
    from reasoning_image_generation_tpu.models.multigraph import cli as mg_cli
    from reasoning_image_generation_tpu.utils import aot
    out = os.path.join(root, "rpm")
    t0 = time.perf_counter()
    cli.main(["--out_dir", out, "--n", str(n), "--batch_size", str(batch),
              "--dedup", "--seed", "0"])
    log(f"rpm cli: {n} samples in {time.perf_counter() - t0:.1f}s "
        f"(cold, compiles included)")
    index = _read_json(os.path.join(out, "index.json"))
    if len(index) != n:
        raise AssertionError(f"index has {len(index)} entries, not {n}")
    errors = [m for m in index if m.get("error")]
    if errors:
        raise AssertionError(f"{len(errors)} error records: "
                             f"{errors[0].get('error_message')}")
    kept = [m for m in index if not m.get("duplicate")]
    leaves = {m["rule"] for m in index}
    grids = glob.glob(os.path.join(out, "grids", "*.png"))
    samples = glob.glob(os.path.join(out, "samples", "sample_*"))
    log(f"  index {len(index)}, kept {len(kept)}, duplicates "
        f"{len(index) - len(kept)}, grids {len(grids)}, sample dirs "
        f"{len(samples)}, leaves {len(leaves)}")
    if n >= 512 and len(leaves) != 9:
        raise AssertionError(f"only {len(leaves)} rule leaves: {leaves}")
    if not (len(grids) == len(samples) == len(kept) > 0.5 * n):
        raise AssertionError("grid/sample/kept counts disagree")
    for m in kept:
        meta = _read_json(os.path.join(m["sample_dir"], "meta.json"))
        coco = _read_json(os.path.join(m["sample_dir"], "coco.json"))
        for k in ("id", "category_path", "grid_path", "sequence", "options",
                  "correct_index", "rule", "grid_phash"):
            if k not in meta:
                raise AssertionError(f"meta.json lacks {k!r}")
        for k in ("images", "annotations", "categories"):
            if k not in coco:
                raise AssertionError(f"coco.json lacks {k!r}")
        n_png = len(glob.glob(os.path.join(m["sample_dir"], "*.png")))
        if n_png < len(meta["sequence"]) + len(meta["options"]):
            raise AssertionError(f"{m['sample_dir']}: {n_png} PNGs")
    log("  meta.json / coco.json parse with the expected keys; state and "
        "option PNGs present")

    mg_out = os.path.join(root, "mg")
    random.seed(0)
    t0 = time.perf_counter()
    mg_cli.main(["--n", str(mg_n), "--out_dir", mg_out, "--dpi", str(dpi),
                 "--modes", ",".join(MG_MODES)])
    log(f"mg cli: {mg_n} images dpi {dpi} in "
        f"{time.perf_counter() - t0:.1f}s")
    counts = {}
    for mode in MG_MODES:
        pngs = glob.glob(os.path.join(mg_out, "images", f"*_{mode}.png"))
        jsons = glob.glob(os.path.join(mg_out, "params", f"*_{mode}.json"))
        if len(pngs) != len(jsons):
            raise AssertionError(f"mg {mode}: {len(pngs)} PNG vs "
                                 f"{len(jsons)} JSON")
        counts[mode] = len(pngs)
    log(f"  mg PNG (= JSON) per mode: {counts}")
    if sum(counts.values()) != mg_n or (mg_n >= 40
                                         and min(counts.values()) == 0):
        raise AssertionError(f"mg counts {counts}")

    # the same CLI run again: every leaf program loads from the AOT cache
    # the first run stored, and every file comes out byte-identical
    before = dict(aot.COUNTS)
    out2 = os.path.join(root, "rpm_again")
    t0 = time.perf_counter()
    cli.main(["--out_dir", out2, "--n", str(n), "--batch_size", str(batch),
              "--dedup", "--seed", "0"])
    log(f"rpm cli again: {n} samples in {time.perf_counter() - t0:.1f}s "
        f"(warm: AOT cache and persistent compile cache)")
    delta = {k: aot.COUNTS[k] - before.get(k, 0) for k in aot.COUNTS}
    log(f"  AOT entries this run: {delta}")
    if delta.get("loaded", 0) < len(leaves) or delta.get("load_failed", 0):
        raise AssertionError(f"AOT cache did not load every leaf: {delta}")
    a, b = _png_bytes(out), _png_bytes(out2)
    diff = [k for k in a if a[k] != b.get(k)]
    log(f"  second run: {len(b)} PNGs, {len(diff)} differ from the first")
    if not a or set(a) != set(b) or diff:
        raise AssertionError(f"second run differs: {diff[:5]}")


# ---------------------------------------------------------------- phase 4
def phase4_gpu_vs_cpu(B: int = 32) -> None:
    import jax
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        LeafPipeline, sample_keys)
    from reasoning_image_generation_tpu.ops.phash import (
        dedup_keep_mask, hamming_matrix)
    cpu = jax.devices("cpu")[0]
    grids = {"gpu": [], "cpu": []}
    hashes = {"gpu": [], "cpu": []}
    for leaf in (LEAF4, LEAF6):
        keys = np.asarray(jax.random.key_data(sample_keys(0, np.arange(B))))
        ug = np.arange(B) % 2 == 0
        for where, renderer in (("gpu", "auto"), ("cpu", "jnp")):
            pipe = LeafPipeline(leaf, GenConfig(seed=0, renderer=renderer,
                                                aot=False, batch_size=B))
            dev = jax.devices()[0] if where == "gpu" else cpu
            k = jax.device_put(jax.random.wrap_key_data(keys), dev)
            out = pipe._batch_fn(k, jax.device_put(ug, dev))
            grids[where].append(np.asarray(out["grid_img"]))
            hashes[where].append(np.asarray(out["grid_phash"]))
    # grids of the two leaves differ in height: compare leaf by leaf
    diffs = [np.abs(g.astype(np.int16) - c)
             for g, c in zip(grids["gpu"], grids["cpu"])]
    dmax = max(int(d.max()) for d in diffs)
    same = (sum(int((d == 0).all(-1).sum()) for d in diffs)
            / sum(d[..., 0].size for d in diffs))
    log(f"gpu vs cpu grids: {[g.shape for g in grids['gpu']]}, max|diff| "
        f"{dmax}, identical pixels {same * 100:.4f}%")
    hg, hc = np.concatenate(hashes["gpu"]), np.concatenate(hashes["cpu"])
    ham = np.asarray(jax.device_get(hamming_matrix(
        np.concatenate([hg, hc]))))[np.arange(len(hg)),
                                     len(hg) + np.arange(len(hg))]
    log(f"gpu vs cpu pHash Hamming: max {int(ham.max())}, "
        f"nonzero {int((ham > 0).sum())} of {len(ham)}")
    kg = np.asarray(dedup_keep_mask(hg))
    kc = np.asarray(dedup_keep_mask(hc))
    log(f"gpu vs cpu kept set: {int(kg.sum())} vs {int(kc.sum())}, "
        f"differ at {np.flatnonzero(kg != kc).tolist()}")
    if dmax > 1 or same < 0.999:
        raise AssertionError("gpu and cpu grids differ beyond tolerance")
    if int(ham.max()) > 2:
        raise AssertionError(f"pHash differs by {int(ham.max())} bits")


# ---------------------------------------------------------------- --four
def four_mesh(root: str, n_ids: int = 256, batch: int = 32,
              canvas=(512, 512), mg_n: int = 64, dpi: int = 200) -> None:
    """RPM and multigraph on the four-GPU mesh against one GPU: PNGs
    byte-identical, dedup decisions identical."""
    import jax
    from reasoning_image_generation_tpu.utils.config import (
        GenConfig, RULE_LEAVES)
    from reasoning_image_generation_tpu.models.rpm.generator import (
        RPMGeneratorTPU)
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    weights = {leaf: 0.0 for leaf in RULE_LEAVES}
    weights[LEAF4] = weights[LEAF6] = 1.0
    ids = list(range(n_ids))
    runs = {}
    for tag, use_mesh in (("mesh", "auto"), ("single", False)):
        cfg = GenConfig(out_dir=os.path.join(root, tag), seed=7,
                        batch_size=batch, canvas_size=tuple(canvas),
                        category_weights=dict(weights), use_mesh=use_mesh)
        gen = RPMGeneratorTPU(cfg)
        size = gen.mesh.size if gen.mesh is not None else 1
        if size != (len(jax.devices()) if tag == "mesh" else 1):
            raise AssertionError(f"{tag}: mesh of {size} devices")
        t0 = time.perf_counter()
        metas = gen.generate_ids(ids, dedup=True)
        gen.close()
        log(f"rpm {tag} ({size} devices): {len(ids)} samples in "
            f"{time.perf_counter() - t0:.1f}s, kept "
            f"{sum(not m.get('duplicate') for m in metas)}")
        runs[tag] = (cfg.out_dir, metas)
    (md, mm), (sd, sm) = runs["mesh"], runs["single"]
    for a, b in zip(mm, sm):
        if (a.get("rule") != b.get("rule")
                or bool(a.get("duplicate")) != bool(b.get("duplicate"))
                or a.get("error") or b.get("error")):
            raise AssertionError(f"rpm sample {a.get('id')} differs")
    pa, pb = _png_bytes(md), _png_bytes(sd)
    bad = [k for k in pa if pa[k] != pb.get(k)]
    log(f"rpm mesh vs single: {len(pa)} vs {len(pb)} PNGs, {len(bad)} differ")
    if not pa or set(pa) != set(pb) or bad:
        raise AssertionError(f"rpm PNGs differ: {bad[:5]}")

    B = mg_n
    modes = [MG_MODES[i % 4] for i in range(B)]
    mg = {}
    for tag in ("mesh", "single"):
        gen = GeometryGeneratorTPU()
        if tag == "single":
            gen.mesh = None  # pin single-device execution
        elif gen.mesh is None or gen.mesh.size != len(jax.devices()):
            raise AssertionError("multigraph generator built no mesh")
        d = os.path.join(root, f"mg_{tag}")
        recs = gen.generate_batches(
            list(range(B)), modes,
            [os.path.join(d, f"{i}_{m}.png") for i, m in enumerate(modes)],
            [os.path.join(d, f"{i}_{m}.json") for i, m in enumerate(modes)],
            dpi=dpi, batch_size=16, dedup=True)
        gen.close()
        mg[tag] = (recs, _png_bytes(d))
    (ra, pa), (rb, pb) = mg["mesh"], mg["single"]
    if [bool(r.get("duplicate")) for r in ra] != \
            [bool(r.get("duplicate")) for r in rb]:
        raise AssertionError("mg dedup decisions differ")
    bad = [k for k in pa if pa[k] != pb.get(k)]
    log(f"mg mesh vs single: {len(pa)} vs {len(pb)} PNGs, {len(bad)} differ")
    if not pa or set(pa) != set(pb) or bad:
        raise AssertionError(f"mg PNGs differ: {bad[:5]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="compare a four-GPU mesh with one GPU, nothing else")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        device = phase0_device(4 if args.four else 1)
        if args.four:
            four_mesh(root)
            if device["count"] != 4:
                raise AssertionError(f"--four ran on {device['count']} GPUs")
        else:
            phase1_kernels()
            phase2_timing()
            phase2_end_to_end()
            phase3_main_path(root)
            phase4_gpu_vs_cpu()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
