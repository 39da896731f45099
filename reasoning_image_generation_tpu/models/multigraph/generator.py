# generator.py — multigraph host orchestration (batch + reference API).
"""GeometryGeneratorTPU: the single-image class-identification pipeline.

API mirrors the reference GeometryGenerator
(multigraph_generation/generator.py:58-568): ``generate(mode, save_path,
params_save_path, dpi, seed)`` returns a GenerationRecord-shaped dict and
writes a PNG + a params JSON with the ShapeParameters field vocabulary
(multigraph_generation/parameter.py:11-30).

The batched addition is ``generate_batch``: N scenes built on host
(microseconds each), rendered in ONE jitted program on device, exported via
the thread pool — replacing the reference's one-matplotlib-figure-per-
process design (multigraph_generation/cli.py:52-58).
"""
from __future__ import annotations

import os
import uuid
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from ...io.writer import ExportPool, ensure_dir
from .scene import build_scene_batch, BOUNDS

_PARAM_FIELDS_DEFAULTS = {
    "rotation": 0.0, "edge_color": None, "line_width": None,
    "line_style": None, "fill_color": None, "alpha": None,
    "has_gradient": False, "gradient_colors": None,
    "has_mask": False, "mask_type": None,
    "has_decoration": False, "decoration_style": None,
}


def _shape_params_dict(meta: Dict) -> Dict:
    """ShapeParameters.__dict__-shaped record (parameter.py:11-30)."""
    out = {
        "shape_id": meta.get("shape_id", ""),
        "shape_type": meta.get("shape_type", ""),
        "center": list(meta.get("center", (0.0, 0.0))),
        "bbox": list(meta.get("bbox", (0, 0, 0, 0))),
        "size": meta.get("size"),
    }
    for k, v in _PARAM_FIELDS_DEFAULTS.items():
        out[k] = meta.get(k, v)
    extra = {k: v for k, v in meta.items()
             if k not in out and k not in ("shape_id", "shape_type")}
    out["extra_params"] = _jsonable(extra)
    out["decoration_artists"] = []
    return _jsonable(out)


class GenerationRecord(dict):
    """Dict with attribute access: JSON-serializable like our records,
    attribute-addressable like the reference's dataclass
    (multigraph_generation/generator.py:43-53)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _finalize_record(rec: Dict, scene: Dict, bounds, dpi: int,
                     params_save_path: Optional[str]) -> None:
    """Pool task: fill in QC (+ geos features for multi-shape scenes),
    then write the params JSON.  Runs on the export pool so the ~10 ms/
    scene of feature geometry overlaps the next batch's device render
    (the reference computes both synchronously per figure,
    multigraph_generation/generator.py:554-563, multi_combinator.py:1086)."""
    from .check import check_scene_inside, compute_scene_features
    # render-time QC (reference multigraph_generation/check.py:82,
    # printed at generator.py:554-563; recorded here instead)
    rec["qc"] = check_scene_inside(scene, bounds, dpi=dpi)
    if rec["shape_count"] > 1:
        # pairwise tangency/crossing features — the reference's
        # compute_geos_features (multi_combinator.py:114-533) dies on
        # a math.lg10 typo; ours is functional
        rec["geos_features"] = _jsonable(compute_scene_features(scene))
    if params_save_path:
        d = os.path.dirname(params_save_path)
        if d:
            ensure_dir(d)
        import json
        # compact (C-encoder) by default, like io/writer.py::submit_json;
        # the reference writes indent=2 (multigraph_generation/
        # generator.py:444) — same content, different whitespace
        with open(params_save_path, "w", encoding="utf-8") as f:
            f.write(json.dumps(rec, ensure_ascii=False,
                               separators=(",", ":")))


class GeometryGeneratorTPU:
    def __init__(self, bounds=BOUNDS, global_scale: float = 1.3,
                 log_level: str = "INFO", io_workers: int = 8,
                 aot: bool = True, transfer_codec: str = "rle4"):
        self.transfer_codec = transfer_codec
        from ...utils.cache import enable_compilation_cache
        enable_compilation_cache()
        self.bounds = bounds
        self.global_scale = float(global_scale)
        self._pool = ExportPool(workers=io_workers)
        # largest run count observed per render size — drives the adaptive
        # shrink of the static transfer buffer (coalesce_shrunk); persisted
        # per-canvas so fresh processes start with converged tiers
        from ...utils.cache import load_run_stats
        self._run_stats: Dict[str, int] = load_run_stats("mg")
        # device->host bytes actually moved (bench.py reports bytes/img)
        self.transfer_bytes: int = 0
        self.generation_history: List[Dict] = []
        self.mesh = self._maybe_make_mesh()
        # AOT executable cache (utils/aot.py): scene batches are fixed-shape
        # (scene.py MAX_SHAPES/MAX_MASKS/MAX_LINES padding), so one cached
        # executable per (dpi, B) covers a whole run; a cold
        # process skips the renderer's trace + lower + compile.
        self._aot_enabled = bool(aot)
        self._aot: Dict[str, object] = {}
        # corpus-level pHash dedup (ops/phash.py::CorpusDedup), armed per
        # generate_batches(dedup=True) run — the reference's ≈1,000-sample
        # dataset claim (reference README.md:8) spans BOTH pipelines, so
        # the single-image corpus filters semantic duplicates too
        self._corpus = None

    @staticmethod
    def _maybe_make_mesh():
        """1-D data mesh over local chips when several are visible — the
        same scale-out the RPM generator uses (models/rpm/generator.py):
        scenes are embarrassingly parallel over the batch axis, so the
        renderer runs under shard_map with zero collectives."""
        import jax
        from ...parallel.mesh import make_mesh
        n = len(jax.local_devices())
        return make_mesh(n) if n > 1 else None

    def _render_imgs(self, batch, dpi: int):
        """Dispatch the (AOT-cached) batch render; returns the async
        device image tensor."""
        from .renderer import render_scene_batch as rfn
        import jax
        from functools import partial
        n = next(iter(batch.values())).shape[0]
        on_mesh = self.mesh is not None and n % self.mesh.size == 0
        # AOT round-trips only when the mesh covers EVERY visible device:
        # deserialize_and_load spans all of them, so a subset-mesh
        # executable reloads with the wrong shard count (utils/aot.py)
        spans_all = (self.mesh is not None
                     and self.mesh.size == jax.device_count())
        tag = (f"mg-render-dpi{dpi}-B{n}"
               + (f"-mesh{self.mesh.size}" if on_mesh else ""))
        if tag not in self._aot:
            from ...utils.aot import load_or_compile
            if on_mesh:
                from jax.sharding import PartitionSpec as P
                # check_vma off: the body has no collectives, and its scan
                # carries start from unvarying constants (raster.py
                # fori_loop inits) the varying-axis checker would reject
                call = jax.jit(jax.shard_map(
                    partial(rfn, dpi=dpi), mesh=self.mesh,
                    in_specs=P("data"), out_specs=P("data"),
                    check_vma=False))
            else:
                call = jax.jit(partial(rfn, dpi=dpi))
            avals = ({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                      for k, v in batch.items()},)
            self._aot[tag] = (load_or_compile(
                tag, call, avals, enabled=self._aot_enabled,
                spans_all_devices=on_mesh and spans_all) or call)
        return self._aot[tag](batch)

    def _pack_budget(self, H: int, W: int) -> int:
        """Device run-buffer budget for the pack path (NOT the transfer
        tier).  default_budget (H*W/24) is sized for dense RPM frames; mg
        outline scenes produce 7-15k runs at 1600^2 while the palettize
        sort/top_k/scatter work scales with the BUFFER, not the content
        (measured: ~3.4 s device time per 50-frame batch at the 106k
        default vs the run content needing <1/7 of that buffer).  Sizes
        from the persisted max-single-frame run count ('M' stat,
        _render_finish) with 2x headroom, quantized to powers of two so
        at most a handful of program shapes ever compile; a frame that
        still overflows falls back to one gathered raw fetch, so an
        optimistic budget costs transfer bytes, never correctness."""
        from ...ops.rle import default_budget
        cap = default_budget(H, W)
        v5 = getattr(self, "transfer_codec", "rle4") == "rle5"
        st = self._run_stats.get(f"mg{'5' if v5 else '4'}:{H}x{W}:M")
        if not st:
            return cap
        want = int(st) * 2 + 1024
        b = 1 << (want - 1).bit_length()
        return min(max(b, 4096), cap)

    def _render_dispatch(self, imgs, extra=None) -> Dict:
        """RLE-pack + blob coalesce on device and start the device->host
        copy; returns a pending-state dict for `_render_finish`.  Nothing
        here blocks on device completion, so a caller can overlap the
        next batch's host work (scene build, QC, export) with this
        batch's device render + transfer.

        `extra` (optional dict of device arrays, e.g. the dedup keep
        mask) rides INSIDE the coalesced blob, so dedup adds no transfer
        of its own per batch."""
        # device->host: RLE-pack on device and move ONE coalesced blob;
        # outline scenes RLE to ~1-3% of the raw 7.7 MB/img at 1600^2.  The
        # static run buffer additionally shrinks to the largest count
        # previously observed (power-of-2 tiers), and frames that still
        # overflow fall back to one gathered raw fetch.
        from ...io.transfer import (coalesce_flat, coalesce_flat_shrunk,
                                    blob_specs, shrunk_specs, transfer_tier)
        from ...ops.rle import pack_batch_rle4, pack_batch_rle5
        H, W = int(imgs.shape[-3]), int(imgs.shape[-2])
        budget = self._pack_budget(H, W)
        v5 = getattr(self, "transfer_codec", "rle4") == "rle5"
        packed = (pack_batch_rle5 if v5 else pack_batch_rle4)(imgs, budget)
        tree = packed if extra is None else (packed, extra)
        leaves, treedef, specs = blob_specs(tree)
        # per-wire-format namespace ('mg4'/'mg5'): a codec with different
        # streams must not inherit another's converged tiers
        skey = f"mg{'5' if v5 else '4'}:{H}x{W}"
        F = int(packed[6 if v5 else 5].shape[0])

        def tier_for(suffix, cap, slack=0):
            st = self._run_stats.get(f"{skey}:{suffix}")
            return transfer_tier(None if st is None else st * F + slack,
                                 cap)

        if v5:
            # v5 leaves: (BM, LNS, IDX, PAL, ESC, LNX, cnt, nc, ec, xc, sc)
            tB = tier_for("B", int(leaves[0].shape[0]), slack=64)
            tS = tier_for("S", int(leaves[1].shape[0]), slack=1024)
            tT = tier_for("T", int(leaves[2].shape[0]))
            tP = tier_for("P", int(leaves[3].shape[0]), slack=1024)
            tE = tier_for("E", int(leaves[4].shape[0]), slack=4096)
            tX = tier_for("X", int(leaves[5].shape[0]), slack=1024)
            sizes = tuple(None if t is None else (0, t)
                          for t in (tB, tS, tT, tP, tE, tX))
            sizes += (None,) * 5
        else:
            tT = tier_for("T", int(leaves[0].shape[0]))
            tP = tier_for("P", int(leaves[2].shape[0]), slack=1024)
            tE = tier_for("E", int(leaves[3].shape[0]), slack=4096)
            tX = tier_for("X", int(leaves[4].shape[0]), slack=1024)
            sizes = (None if tT is None else (0, tT),
                     None if tT is None else (0, tT),
                     None if tP is None else (0, tP),
                     None if tE is None else (0, tE),
                     None if tX is None else (0, tX),
                     None, None, None, None)
        sizes += (None,) * (len(leaves) - len(sizes))  # extras ship whole
        if any(s is not None for s in sizes):
            blob = coalesce_flat_shrunk(leaves, sizes)
            specs = shrunk_specs(leaves, sizes)
        else:
            blob = coalesce_flat(leaves)
        getattr(blob, "copy_to_host_async", lambda: None)()
        return {"blob": blob, "treedef": treedef, "specs": specs,
                "skey": skey, "imgs": imgs, "hw": (H, W),
                "budget": budget, "has_extra": extra is not None}

    def _render_finish(self, st: Dict):
        """Block on the pending transfer from `_render_dispatch` and
        build the host-side frame views (+ raw overflow frames + any
        blob-carried extras)."""
        from ...io.transfer import split_flat, gather_frames
        from ...ops.rle import Rle3Frames, PAL_K
        blob = np.asarray(st["blob"])
        self.transfer_bytes += blob.nbytes
        tree = split_flat(blob, st["treedef"], st["specs"])
        packed, extra = (tree if st.get("has_extra") else (tree, None))
        frames = Rle3Frames(packed, st["budget"])
        skey = st["skey"]
        F = max(frames.cnt.size, 1)
        stats = [("T", int(frames.cnt.sum())),
                 ("P", int(np.minimum(frames.nc, PAL_K).sum())),
                 ("E", int(frames.ec.sum()))]
        if frames.xc is not None:
            stats.append(("X", int(frames.xc.sum())))
        if frames.BM is not None:  # v5: bitmask bytes + != 1 lengths
            # clamp to the run budget: the device ships ceil(min(cnt,cap)/8)
            # bitmask bytes, so overflow frames must not inflate the B tier
            stats.append(("B", int((
                (np.minimum(frames.cnt, st["budget"]) + 7) // 8).sum())))
            stats.append(("S", int(frames.sc.sum())))
        for suf, tot in stats:
            k = f"{skey}:{suf}"
            self._run_stats[k] = max(self._run_stats.get(k, 0.0), tot / F)
        # max SINGLE-frame run count (not an average): drives the pack
        # compute budget (_pack_budget), true even when this batch's
        # buffer truncated (cnt always carries the pre-cap count)
        mk = f"{skey}:M"
        self._run_stats[mk] = max(self._run_stats.get(mk, 0),
                                  int(frames.cnt.max()))
        over = gather_frames(st["imgs"], frames.overflow_indices(F))
        if over:
            self.transfer_bytes += sum(a.nbytes for a in over.values())
        return frames, over, st["hw"], extra

    def generate(self, mode: str = "random", save_path: Optional[str] = None,
                 params_save_path: Optional[str] = None, dpi: int = 200,
                 seed: Optional[int] = None,
                 center_on_canvas: bool = True) -> Dict:
        recs = self.generate_batch([seed if seed is not None else 0], [mode],
                                   [save_path], [params_save_path], dpi=dpi)
        # preserve the reference API's synchronous contract: QC/features
        # run on the pool, so the record is complete only after a drain
        self._pool.drain()
        return recs[0]

    def generate_batch(self, seeds, modes, save_paths=None,
                       params_save_paths=None, dpi: int = 200) -> List[Dict]:
        return self._finish_batch(self._dispatch_batch(
            seeds, modes, save_paths, params_save_paths, dpi))

    def generate_batches(self, seeds, modes, save_paths=None,
                         params_save_paths=None, dpi: int = 200,
                         batch_size: int = 16, progress=None,
                         dedup: bool = False,
                         dedup_threshold: int = 4) -> List[Dict]:
        """Software-pipelined multi-batch driver.

        Batch k+1's host scene build and device render/pack run while
        batch k's transfer completes and its host tail (QC, geos
        features, PNG/JSON export submission) executes — the same
        one-deep pipeline the RPM generator uses.  `progress(done)` is
        called after each finished batch.

        With ``dedup=True`` every rendered scene is pHashed on device and
        filtered against the run's corpus (ops/phash.py::CorpusDedup);
        near-duplicates get a ``duplicate: True`` record and no PNG/JSON
        artifacts."""
        n = len(seeds)
        from ...ops.phash import CorpusDedup
        self._corpus = (CorpusDedup(n, mesh=self.mesh,
                                    threshold=dedup_threshold)
                        if dedup else None)
        save_paths = save_paths or [None] * n
        params_save_paths = params_save_paths or [None] * n
        records: List[Dict] = []
        pending = None
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            st = self._dispatch_batch(
                seeds[lo:hi], modes[lo:hi], save_paths[lo:hi],
                params_save_paths[lo:hi], dpi)
            if pending is not None:
                records.extend(self._finish_batch(pending))
                if progress:
                    progress(len(records))
            pending = st
        if pending is not None:
            records.extend(self._finish_batch(pending))
            if progress:
                progress(len(records))
        self._corpus = None  # scope the corpus to this run
        return records

    def _dispatch_batch(self, seeds, modes, save_paths, params_save_paths,
                        dpi: int) -> Dict:
        n = len(seeds)
        batch, metas = build_scene_batch(seeds, modes, self.global_scale)
        imgs = self._render_imgs(batch, dpi)
        handle = extra = None
        if self._corpus is not None:
            # device-resident pHash of the rendered batch; the keep mask
            # rides INSIDE the coalesced blob (single-device path) so
            # dedup adds zero extra transfers per batch
            from ...ops.phash import phash_batch
            handle = self._corpus.submit(phash_batch(imgs), n)
            if handle[0] == "dev":
                extra = {"keep": handle[1]}
        st = self._render_dispatch(imgs, extra)
        st["_keep_handle"] = handle
        st.update(seeds=seeds, modes=modes, dpi=dpi,
                  save_paths=save_paths or [None] * n,
                  params_save_paths=params_save_paths or [None] * n,
                  batch=batch, metas=metas)
        return st

    def _finish_batch(self, st: Dict) -> List[Dict]:
        seeds, modes = st["seeds"], st["modes"]
        save_paths, params_save_paths = (st["save_paths"],
                                         st["params_save_paths"])
        batch, metas, dpi = st["batch"], st["metas"], st["dpi"]
        n = len(seeds)
        frames, over, (H, W), extra = self._render_finish(st)
        handle = st.get("_keep_handle")
        if extra is not None:
            keep = extra["keep"][:n].astype(bool)
        elif handle is not None:
            keep = self._corpus.resolve(handle)
        else:
            keep = np.ones(n, bool)

        records = []
        for i in range(n):
            rec = GenerationRecord({
                "generation_id": str(uuid.uuid4()),
                "timestamp": datetime.now().isoformat(),
                "seed": int(seeds[i]),
                "mode": modes[i],
                "shape_count": metas[i]["shape_count"],
                "bounds": list(self.bounds),
                "global_scale": self.global_scale,
                "shapes": [_shape_params_dict(m) for m in metas[i]["shapes"]],
            })
            if not keep[i]:
                # near-duplicate of an earlier scene: record, don't export
                rec["duplicate"] = True
                self.generation_history.append(rec)
                records.append(rec)
                continue
            if save_paths[i]:
                d = os.path.dirname(save_paths[i])
                if d:
                    ensure_dir(d)
                if i in over:
                    self._pool.submit_png(save_paths[i], over[i])
                else:
                    # pixel-free path: PNG encoded in C straight from the
                    # compacted rle3 stream (palette lookup in the worker)
                    self._pool.submit_png_rle3(save_paths[i], frames, i,
                                               H, W)
            # QC + geos features are ~10 ms/scene of host work — off the
            # dispatch thread so they overlap the next batch's device
            # render; the params JSON is written by the same task AFTER
            # the record is complete
            scene_i = {k: v[i] for k, v in batch.items()}
            self._pool.submit(_finalize_record, rec, scene_i, self.bounds,
                              dpi, params_save_paths[i])
            self.generation_history.append(rec)
            records.append(rec)
        return records

    def close(self):
        from ...utils.cache import save_run_stats
        save_run_stats("mg", self._run_stats)
        self._pool.close()
