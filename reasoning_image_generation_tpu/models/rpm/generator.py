# generator.py — host orchestration: leaf grouping, batching, export.
"""Batch generator for the RPM sequence-puzzle pipeline.

Replaces the reference's per-sample RPMGenerator + process-pool driver
(reference src/generator.py:33, src/cli.py:54-133) with:

1. host-side per-sample leaf + use_grid sampling (python Random seeded
   `seed + sample_id`, matching the reference's per-sample seeding scheme,
   reference src/cli.py:20-21, src/generator.py:257,270);
2. grouping of sample ids by rule leaf (each leaf is a statically-compiled
   XLA program, see pipeline.py);
3. device-batched generation; the only host work per sample is PNG/JSON
   export on a thread pool.

Output directory layout is identical to the reference:
  out/samples/sample_%06d/{state_i.png, option_j.png, proto_true_next.png,
                           query.png, meta.json, coco.json}
  out/grids/grid_%06d.png
  out/index.json
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from collections import defaultdict
from typing import Dict, List

import jax
import numpy as np

from ...utils.config import GenConfig, category_leaves
from ...io.writer import ExportPool, ensure_dir
from .pipeline import LeafPipeline, sample_keys
from .metadata import build_sample_meta, build_coco

logger = logging.getLogger(__name__)


RAW_KEYS = ("state_imgs", "option_imgs", "grid_img", "grid_phash",
            "grid_phash_full")

# codecs whose run streams batch-compact on device into one flat blob
# (ops/rle.py compact_* family; tuple arity identifies the wire format:
# 7 = rle3, 9 = rle4 u8-length, 11 = rle5 length-1 bitmask)
_COMPACT_CODECS = ("rle3", "rle3d", "rle4", "rle4d", "rle5", "rle5d")

# self-healing transfer tiers: a stream whose frames overflow its frozen
# tier for this many CONSECUTIVE batches gets its tier re-frozen mid-run
# at the observed demand (one extra compiled coalesce shape) instead of
# paying ~786 KB raw-frame fetches for the rest of the run — the round-3
# cascade (2.06 MB/sample) this guards against
TIER_REFREEZE_AFTER = 2

# overflow_reasons() stream names -> packed-output keys (for mapping the
# per-stream attribution back onto tier-stat namespaces)
_STREAM_PKEY = {"grid": "grid_img_packed", "state": "state_imgs_packed",
                "opt": "option_imgs_packed"}

# single-blob transfer helpers shared with the multigraph generator —
# see io/transfer.py for the per-transfer-cost rationale
from ...io.transfer import (coalesce as _coalesce, blob_specs as _blob_specs,
                            split_blob as _split_blob,
                            coalesce_shrunk as _coalesce_shrunk,
                            shrunk_specs as _shrunk_specs, transfer_tier,
                            coalesce_flat as _coalesce_flat,
                            coalesce_flat_shrunk as _coalesce_flat_shrunk,
                            split_flat as _split_flat,
                            gather_frames as _gather_frames,
                            unpack_images as _unpack_images, HostBufferRing)


def _resolve_meta(m):
    """metas[] values are dicts or pool Futures of dicts (see _meta_task);
    call only after the export pool drained."""
    return m.result() if hasattr(m, "result") else m


def _meta_task(sid, leaf, path, out_dir, sample_dir, grid_path, states_np,
               options_np, params_np, b, perm, correct, use_grid, grid_size,
               canvas_size, layout, seed, phash_hex, grid_only, export_json,
               export_coco, pretty):
    """Pool task: slice the batch trees, build meta (+ coco) and write the
    JSONs.  Was ~1.5-2 s of main-thread work per 1k window (the per-sample
    tree.map slicing plus build_sample_meta's float conversion storm);
    returns the meta dict — generate_ids resolves the Future before
    returning.  Must not raise (drain() re-raises worker exceptions), so
    failures degrade to the per-sample error-record shape."""
    try:
        sample_states = jax.tree.map(lambda a: a[b], states_np)
        sample_options = jax.tree.map(lambda a: a[b], options_np)
        sample_params = jax.tree.map(lambda a: a[b], params_np)
        meta = build_sample_meta(
            sid, leaf, path, out_dir, sample_dir, grid_path,
            sample_states, sample_options, perm, correct,
            sample_params, use_grid, grid_size, canvas_size, layout,
            seed, (seed or 0) + sid, grid_only=grid_only)
        meta["grid_phash"] = phash_hex
        if export_json:
            data = json.dumps(
                meta, ensure_ascii=False, indent=2 if pretty else None,
                separators=None if pretty else (",", ":"))
            with open(os.path.join(sample_dir, "meta.json"), "w",
                      encoding="utf-8") as f:
                f.write(data)
        if export_coco:
            coco = build_coco(sid, leaf, grid_path, out_dir,
                              layout.grid_h, meta["cells_meta"])
            data = json.dumps(
                coco, ensure_ascii=False, indent=2 if pretty else None,
                separators=None if pretty else (",", ":"))
            with open(os.path.join(sample_dir, "coco.json"), "w",
                      encoding="utf-8") as f:
                f.write(data)
        return meta
    except Exception as e:  # pragma: no cover - defensive
        logger.error("meta build failed for sample %d: %s", sid, e)
        return {"index": int(sid), "error": True,
                "error_type": str(type(e)), "error_message": str(e)}


def _write_delta_sample(s_fr, o_fr, over_state, over_opt, b: int, L: int,
                        O: int, fh: int, fw: int, sample_dir: str,
                        perm) -> None:
    """Pool task: materialize one sample's delta-coded (rle3d) frames and
    write their PNGs.  State t decodes against decoded state t-1 (state 0
    is a keyframe; raw overflow fetches substitute exactly), options
    against state L-1 — mirroring the device-side bases in
    models/rpm/pipeline.py."""
    from ...io.png import write_png
    # keyframes contain no copy runs, so the base is never read
    dummy = np.broadcast_to(np.zeros(3, np.uint8), (fh, fw, 3))
    prev = dummy
    for t in range(L):
        fi = b * L + t
        if fi in over_state:
            px = over_state[fi]
        else:
            px = s_fr.unpack_delta(fi, prev, (fh, fw))
        write_png(os.path.join(sample_dir, f"state_{t}.png"), px)
        prev = px
    for pos in range(O):
        fi = b * O + pos
        src = int(perm[pos])
        # distractor files keep their pre-shuffle index j (reference
        # writes option_j.png at generation time, src/generator.py:500)
        name = "proto_true_next.png" if src == 0 else f"option_{src}.png"
        px = (over_opt[fi] if fi in over_opt
              else o_fr.unpack_delta(fi, prev, (fh, fw)))
        write_png(os.path.join(sample_dir, name), px)


class RPMGeneratorTPU:
    def __init__(self, config: GenConfig, show_labels: bool = True,
                 show_border: bool = True, io_workers: int = 8,
                 use_threads: bool = True):
        from ...utils.cache import enable_compilation_cache
        enable_compilation_cache()
        self.cfg = config
        self.out_dir = config.out_dir
        self.samples_dir = os.path.join(self.out_dir, "samples")
        self.grids_dir = os.path.join(self.out_dir, "grids")
        ensure_dir(self.samples_dir)
        ensure_dir(self.grids_dir)
        self.show_labels = show_labels
        self.show_border = show_border
        self._pipelines: Dict[str, LeafPipeline] = {}
        self._pool = ExportPool(workers=io_workers, use_threads=use_threads)
        self._leaves = category_leaves(config.categories)
        self._bufs = HostBufferRing()
        # observed max run count per packed tensor key — drives the
        # adaptive shrink of the static codec buffers before transfer
        # (io/transfer.py::coalesce_shrunk).  Seeded from the persisted
        # per-canvas stats so a fresh process starts with converged tiers.
        from ...utils.cache import load_run_stats
        W, H = config.canvas_size
        # codec-specific namespace: tiers only ever grow (max-seen), so a
        # codec with smaller streams (rle3d) must not inherit another's
        # converged tiers
        codec = getattr(config, "transfer_codec", "rle4d")
        suffix = "" if codec == "rle3" else f"_{codec}"
        self._stats_name = f"rpm_{W}x{H}_g{config.grid_size}{suffix}"
        self._run_stats: Dict[str, int] = load_run_stats(self._stats_name)
        # tier decisions FREEZE at generate_ids entry (a mid-run tier bump
        # would compile a new program shape — ~2 s each even warm-cached;
        # stats keep updating for the NEXT call/process)
        self._tier_stats: Dict[str, int] = dict(self._run_stats)
        # device->host bytes actually moved (blob + overflow fetches);
        # bench.py reports bytes/sample beside every rate
        self.transfer_bytes: int = 0
        # frames that exceeded their (adaptively shrunk) codec capacity
        # and fell back to a raw 786 KB fetch — the early-warning signal
        # for an undersized transfer tier
        self.overflow_frames: int = 0
        # self-healing tiers: a stream that overflows TIER_REFREEZE_AFTER
        # consecutive batches gets its tier re-frozen mid-run at the
        # observed demand (one extra compiled coalesce shape) instead of
        # paying raw-frame fallbacks for the rest of the run
        self.tiers_refrozen: int = 0
        self._overflow_streak: Dict[str, int] = {}
        self._batch_ordinal: int = 0
        self.overflow_events: list = []  # (batch_ordinal, {stream: frames})
        self.mesh = self._maybe_make_mesh()

    def _maybe_make_mesh(self):
        """Build the 1-D data mesh over this host's LOCAL devices.

        The device-parallel equivalent of the reference's process-pool fan-out
        over sample ids (reference src/cli.py:85-129): the per-sample batch
        axis is sharded over every local device, and the corpus dedup's
        pHash all_gather is the workload's only collective.

        Multi-host scale-out is one independent process per host over a
        disjoint id shard (--num_hosts/--host_id) with merge-time
        cross-host dedup (cli.merge_host_indexes): each host's leaf-group
        sequence depends on its own id shard, so a global lockstep mesh
        cannot be fed coherently from per-host batches — the generator
        refuses a multi-process JAX runtime rather than deadlock in the
        first cross-host collective."""
        import jax
        from ...parallel.mesh import make_mesh
        want = getattr(self.cfg, "use_mesh", "auto")
        if want is False:
            return None
        if jax.process_count() > 1:
            raise NotImplementedError(
                "RPMGeneratorTPU does not run under a multi-process JAX "
                "runtime (jax.distributed): launch one independent process "
                "per host with --num_hosts/--host_id instead — disjoint id "
                "shards, merge-time cross-host dedup.")
        n_dev = len(jax.local_devices())
        if want == "auto" and n_dev <= 1:
            return None
        # largest device count that divides the batch (exactly one compiled
        # program shape per leaf requires an evenly sharded batch)
        n = max(d for d in range(1, n_dev + 1)
                if self.cfg.batch_size % d == 0)
        return make_mesh(n) if n > 1 else None

    # ---- host-side per-sample choices (weighted leaf + use_grid coin) ----
    def _sample_assignments(self, sample_ids) -> Dict[str, List]:
        weights = [self.cfg.category_weights.get(l[-1], 1.0) for l in self._leaves]
        groups: Dict[str, List] = defaultdict(list)
        for sid in sample_ids:
            rng = random.Random((self.cfg.seed or 0) + sid)
            path = rng.choices(self._leaves, weights=weights, k=1)[0]
            use_grid = rng.choice([False, True])
            groups[path[-1]].append((sid, path, use_grid))
        return groups

    def _pipeline(self, leaf: str) -> LeafPipeline:
        if leaf not in self._pipelines:
            self._pipelines[leaf] = LeafPipeline(
                leaf, self.cfg, show_labels=self.show_labels,
                show_border=self.show_border, mesh=self.mesh)
        return self._pipelines[leaf]

    def generate(self, n: int, progress: bool = False, dedup: bool = False,
                 dedup_threshold: int = 4, resume: bool = False) -> List[dict]:
        return self.generate_ids(list(range(n)), progress=progress,
                                 dedup=dedup, dedup_threshold=dedup_threshold,
                                 resume=resume)

    def generate_sample(self, sample_id: int, category_path=None,
                        show_labels: bool = True, show_border: bool = True):
        """Reference-API single-sample entry
        (reference src/generator.py:210): returns the meta dict, or None on
        failure.  `category_path` pins the rule leaf; labels/borders follow
        the generator's construction-time settings (they are baked into the
        compiled layout overlay).

        Batched `generate()`/`generate_ids()` are the production path —
        this exists so reference callers can switch without code changes."""
        if category_path is not None:
            leaf = category_path[-1]
            sid = sample_id
            rng = random.Random((self.cfg.seed or 0) + sid)
            # consume the leaf draw like _sample_assignments, then force it
            rng.choices(self._leaves, k=1)
            use_grid = rng.choice([False, True])
            groups = {leaf: [(sid, list(category_path), use_grid)]}
            metas: Dict[int, dict] = {}
            work = list(groups.items())
            pipe = self._pipeline(leaf)
            entry = work[0][1]
            import jax
            ids = [entry[0][0]]
            B = self.cfg.batch_size
            pad_ids = ids + [ids[-1]] * (B - 1)
            ug = np.asarray([entry[0][2]] + [False] * (B - 1))
            keys = sample_keys(self.cfg.seed or 0, np.asarray(pad_ids))
            out = pipe(keys, ug)
            out = jax.tree.map(lambda a: a[:1], out)
            self._flush((leaf, pipe, entry, out), metas)
            self._pool.drain()
            meta = _resolve_meta(metas.get(sample_id))
            return None if (meta and meta.get("error")) else meta
        metas = self.generate_ids([sample_id])
        meta = metas[0] if metas else None
        return None if (meta and meta.get("error")) else meta

    def _load_existing_meta(self, sid: int):
        """Resume support: outputs are idempotent by sample id
        (SURVEY.md §5.4); a sample with an existing meta.json is reused."""
        import json
        path = os.path.join(self.samples_dir, f"sample_{sid:06d}", "meta.json")
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    return json.load(f)
            except Exception:
                return None
        return None

    def _compile_leaves(self, leaves: List[str]) -> None:
        """Compile (or load from the AOT cache) every leaf program a run
        needs, concurrently: XLA compiles outside the interpreter lock,
        so a cold start costs about its slowest program instead of the
        sum of nine.  Where the AOT cache is off, programs compile at
        their first dispatch as before."""
        from concurrent.futures import ThreadPoolExecutor
        pipes = [self._pipeline(leaf) for leaf in leaves]
        if len(pipes) < 2:
            return
        B = self.cfg.batch_size
        keys = sample_keys(self.cfg.seed or 0, np.arange(B))
        use_grid = np.zeros(B, bool)
        with ThreadPoolExecutor(max_workers=len(pipes)) as ex:
            for f in [ex.submit(p._compiled_for, keys, use_grid)
                      for p in pipes]:
                f.result()

    def warmup(self, sample_ids: List[int]) -> None:
        """Compile every pipeline the given ids would use WITHOUT pulling
        images to the host (no transfer, no export).  Per-leaf compiles are
        dispatched from a thread pool — compilation dominates and XLA
        compiles outside the interpreter lock."""
        import jax
        from concurrent.futures import ThreadPoolExecutor

        jobs = []
        for leaf, entries in self._sample_assignments(sample_ids).items():
            pipe = self._pipeline(leaf)
            B = self.cfg.batch_size
            for start in range(0, len(entries), B):
                chunk = entries[start:start + B]
                ids = [e[0] for e in chunk]
                pad_ids = ids + [ids[-1]] * (B - len(ids))
                use_grid = np.asarray([e[2] for e in chunk] +
                                      [False] * (B - len(ids)))
                keys = sample_keys(self.cfg.seed or 0, np.asarray(pad_ids))
                jobs.append((pipe, keys, use_grid))

        def run(job):
            pipe, keys, use_grid = job
            out = pipe(keys, use_grid)
            jax.block_until_ready(out["grid_img"])

        with ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(run, jobs))

    def measure_device_rate(self, sample_ids: List[int],
                            iters: int = 10, blocking: bool = False) -> float:
        """On-device samples/s, with host<->device roundtrip latency
        amortized out: per batch, queue `iters` dispatches back-to-back and
        force completion once with a scalar readback (the device executes
        them sequentially), so per-dispatch host latency is not billed as
        device time.  Call warmup() first so compilation is excluded.

        ``blocking=True`` syncs after every dispatch instead — the
        conservative per-batch-latency methodology; both numbers are
        reported by bench.py so round-over-round deltas can't hide in a
        methodology change."""
        import time as _time
        import jax

        jobs = []
        for leaf, entries in self._sample_assignments(sample_ids).items():
            pipe = self._pipeline(leaf)
            B = self.cfg.batch_size
            leaf_jobs = []
            for start in range(0, len(entries), B):
                chunk = entries[start:start + B]
                ids = [e[0] for e in chunk]
                pad_ids = ids + [ids[-1]] * (B - len(ids))
                use_grid = np.asarray([e[2] for e in chunk] +
                                      [False] * (B - len(ids)))
                keys = sample_keys(self.cfg.seed or 0, np.asarray(pad_ids))
                leaf_jobs.append((pipe, keys, use_grid, len(ids)))
            # steady-state measurement: prefer full batches (padding in a
            # ragged tail batch would be billed as dead time)
            full = [j for j in leaf_jobs if j[3] == B]
            jobs.extend(full if full else leaf_jobs[:1])

        total_samples = 0
        total_time = 0.0
        for pipe, keys, use_grid, n_real in jobs:
            out = pipe(keys, use_grid)
            _ = np.asarray(out["grid_img"].reshape(-1)[0])  # warm + sync
            t0 = _time.perf_counter()
            for _i in range(iters):
                out = pipe(keys, use_grid)
                if blocking:
                    _ = np.asarray(out["grid_img"].reshape(-1)[0])
            if not blocking:
                _ = np.asarray(out["grid_img"].reshape(-1)[0])
            total_time += _time.perf_counter() - t0
            total_samples += n_real * iters
        return total_samples / total_time if total_time > 0 else 0.0

    def generate_ids(self, sample_ids: List[int], progress: bool = False,
                     dedup: bool = False, dedup_threshold: int = 4,
                     resume: bool = False) -> List[dict]:
        import jax
        metas: Dict[int, dict] = {}
        if resume:
            remaining = []
            for sid in sample_ids:
                meta = self._load_existing_meta(sid)
                if meta is not None:
                    metas[sid] = meta
                else:
                    remaining.append(sid)
            sample_ids = remaining
        # streaming corpus dedup (ops/phash.py::CorpusDedup): device-
        # resident corpus single-chip, sharded collective on a mesh;
        # pre-sized to this run so no mid-run recompile
        from ...ops.phash import CorpusDedup
        self._corpus = (CorpusDedup(len(sample_ids), mesh=self.mesh,
                                    threshold=dedup_threshold)
                        if dedup else None)

        # freeze tier choices for this whole run (stats continue updating
        # for the next call); see _tier_stats in __init__
        self._tier_stats = dict(self._run_stats)

        groups = self._sample_assignments(sample_ids)
        self._compile_leaves(list(groups))
        t0 = time.time()
        done = 0

        # software pipeline: dispatch batch k+1 to the device before pulling
        # batch k's images to the host, so XLA compute overlaps the
        # device->host transfer + PNG/JSON export
        pending = None
        work = []
        for leaf, entries in groups.items():
            B = self.cfg.batch_size
            for start in range(0, len(entries), B):
                work.append((leaf, entries[start:start + B]))

        for leaf, chunk in work:
            pipe = self._pipeline(leaf)
            ids = [e[0] for e in chunk]
            # pad ragged chunks to the FULL batch size: exactly ONE compiled
            # program shape per leaf, ever.  Wasted compute on padding is
            # milliseconds; every extra compiled shape costs 30-200s.
            # (padded outputs are generated and discarded)
            Bp = self.cfg.batch_size
            pad_ids = ids + [ids[-1]] * (Bp - len(ids))
            use_grid = np.asarray([e[2] for e in chunk] +
                                  [False] * (Bp - len(ids)))
            keys = sample_keys(self.cfg.seed or 0, np.asarray(pad_ids))
            out = pipe(keys, use_grid)  # async dispatch
            n_real = len(ids)
            # big image tensors stay device-resident: raw frames are only
            # the overflow fallback when a packed codec carries them, and
            # the dedup collective reads the phashes on device.  EVERYTHING
            # else fuses into one u8 blob -> a single device->host transfer
            # per batch (one large copy instead of many small ones);
            # full batch, not [:n_real] — slicing happens on host so the
            # coalesce program compiles once per leaf
            skip = set()
            if "state_imgs_packed" in out:
                skip |= {"state_imgs", "option_imgs"}
            if "grid_img_packed" in out:
                skip |= {"grid_img"}
            transfer = {k: v for k, v in out.items() if k not in skip}
            codec = getattr(self.cfg, "transfer_codec", "rle4d")
            if codec in _COMPACT_CODECS:
                # batch-compact + palettize the run streams on device
                # (ops/rle.py::compact_rle3/compact_rle3d, the u8-length
                # v4 variants, and the length-1-bitmask v5 variants) —
                # outside the mesh-sharded pipeline jit, so this is where
                # shards get gathered.  Delta streams (4-tuple: + copy
                # mask) come from pack_batch_rle2_delta; the grid stays
                # non-delta.
                from ...ops import rle as _rle
                base = codec.rstrip("d")
                c_plain = getattr(_rle, f"compact_{base}")
                c_delta = getattr(_rle, f"compact_{base}d")
                for key in list(transfer):
                    if key.endswith("_packed"):
                        val = transfer[key]
                        transfer[key] = (c_delta(*val) if len(val) == 4
                                         else c_plain(*val))
            keep_handle = None
            if self._corpus is not None:
                # dispatch the dedup step now so the keep mask can ride
                # INSIDE the coalesced blob (single-device path) instead
                # of costing a transfer of its own
                keep_handle = self._corpus.submit(out["grid_phash"],
                                                  n_real)
                if keep_handle[0] == "dev":
                    transfer["_keep"] = keep_handle[1]
            flat_blob = codec in _COMPACT_CODECS
            leaves, treedef, specs = _blob_specs(transfer)
            sizes = self._shrink_sizes(leaf, transfer)
            if any(s is not None for s in sizes):
                blob = (_coalesce_flat_shrunk if flat_blob
                        else _coalesce_shrunk)(leaves, sizes)
                specs = _shrunk_specs(leaves, sizes)
            else:
                blob = (_coalesce_flat if flat_blob else _coalesce)(leaves)
            getattr(blob, "copy_to_host_async", lambda: None)()
            # device-resident handles: raw frames (overflow fallback) and
            # the full-batch phashes (the sharded dedup collective needs
            # even shards and device residency)
            raw = {k: out[k] for k in skip if k in out}
            raw["grid_phash_full"] = out["grid_phash"]
            if keep_handle is not None:
                raw["_keep_handle"] = keep_handle

            if pending is not None:
                done += self._flush(pending, metas)
                if progress:
                    dt = time.time() - t0
                    logger.info("generated %d samples (%.2f samples/s)",
                                done, done / max(dt, 1e-9))
            pending = (leaf, pipe, chunk, (blob, treedef, specs, raw, n_real))

        if pending is not None:
            done += self._flush(pending, metas)
            if progress:
                dt = time.time() - t0
                logger.info("generated %d samples (%.2f samples/s)",
                            done, done / max(dt, 1e-9))
        self._pool.drain()
        # meta builds run on the pool (Futures); all done after the drain
        return [_resolve_meta(metas[i]) for i in sorted(metas)]

    def _flush(self, pending, metas) -> int:
        """Export one batch; failures become per-sample error records in the
        index instead of aborting the run (reference src/cli.py:25-34)."""
        import traceback
        p_leaf, p_pipe, p_chunk, p_out = pending
        try:
            self._export_batch(p_leaf, p_pipe, p_chunk, p_out, metas)
        except Exception as e:
            tb = traceback.format_exc()
            logger.error("batch export failed (%s): %s", p_leaf, e)
            for sid, path, _ug in p_chunk:
                metas[sid] = {
                    "index": int(sid), "error": True,
                    "error_type": str(type(e)), "error_message": str(e),
                    "traceback": tb,
                }
        return len(p_chunk)

    def _shrink_sizes(self, leaf: str, transfer) -> tuple:
        """Static per-leaf-array truncation spec for coalesce_shrunk,
        aligned with jax.tree.flatten(transfer) order (dict keys sorted;
        tuple elements in order).  Packed run buffers shrink to the
        transfer tier covering the largest run count this rule leaf has
        produced so far (run statistics differ ~3x between leaves —
        平移 max 3.8k runs vs 直接叠加 10.6k); everything else travels
        whole.  Tiers quantize to 512 runs and only ever grow (max-seen is
        monotone), so a handful of program shapes compile per leaf.  A
        frame that exceeds a shrunken capacity hits the existing raw-frame
        overflow fallback on decode, so an optimistic tier costs one extra
        gathered fetch, never correctness."""
        codec = getattr(self.cfg, "transfer_codec", "rle4d")
        sizes = []
        for key in sorted(transfer):
            val = transfer[key]
            n_leaves = len(jax.tree.leaves(val))
            if (key.endswith("_packed") and n_leaves in (7, 9, 11)
                    and codec in _COMPACT_CODECS):
                # compacted streams: tier each stream AXIS (batch totals,
                # not per-frame counts).  Stats store per-frame averages
                # so a different batch size next run still produces a
                # sane tier.
                if n_leaves == 11:
                    # v5: (BM, LNS, IDX, PAL, ESC, LNX, cnt, nc, ec,
                    #      xc, sc)
                    BM, LNS, IDX, PAL, ESC, LNX = val[:6]
                    F = int(np.prod(val[6].shape, dtype=np.int64))

                    def t5(suffix, cap, slack=0):
                        st = self._tier_stats.get(f"{leaf}:{key}:{suffix}")
                        return transfer_tier(
                            None if st is None else st * F + slack, cap)

                    tB = t5("B", int(BM.shape[0]), slack=64)
                    tS = t5("S", int(LNS.shape[0]), slack=1024)
                    tT = t5("T", int(IDX.shape[0]))
                    tP = t5("P", int(PAL.shape[0]), slack=1024)
                    tE = t5("E", int(ESC.shape[0]), slack=4096)
                    tX = t5("X", int(LNX.shape[0]), slack=1024)
                    sizes += [None if t is None else (0, t)
                              for t in (tB, tS, tT, tP, tE, tX)]
                    sizes += [None] * 5
                    continue
                LN, _IDX, PAL, ESC = val[0], val[1], val[2], val[3]
                F = int(np.prod(val[5 if n_leaves == 9 else 4].shape,
                                dtype=np.int64))

                def tier_for(suffix, cap, slack=0):
                    st = self._tier_stats.get(f"{leaf}:{key}:{suffix}")
                    return transfer_tier(
                        None if st is None else st * F + slack, cap)

                # run totals concentrate (~sqrt(F) below single-frame
                # variance) so the 1.2x multiplicative headroom covers
                # them; escape/palette totals are BURSTY — one >255-color
                # frame adds hundreds of escapes to a near-zero average.
                # Absolute slack is ~15 KB/batch; an undersized tier is a
                # cascade of 786 KB raw-frame fetches.
                tT = tier_for("T", int(LN.shape[0]))
                tP = tier_for("P", int(PAL.shape[0]), slack=1024)
                tE = tier_for("E", int(ESC.shape[0]), slack=4096)
                sizes += [None if tT is None else (0, tT),
                          None if tT is None else (0, tT),
                          None if tP is None else (0, tP),
                          None if tE is None else (0, tE)]
                if n_leaves == 9:
                    # v4 extension stream (u16 lengths of runs >255):
                    # per-frame counts are structural (fill spans) but a
                    # single busy frame can double them — same absolute
                    # slack policy as the palette stream
                    tX = tier_for("X", int(val[4].shape[0]), slack=1024)
                    sizes += [None if tX is None else (0, tX),
                              None, None, None, None]
                else:
                    sizes += [None, None, None]
                continue
            if not (key.endswith("_packed") and codec in ("rle", "rle2")):
                sizes += [None] * n_leaves
                continue
            cap = int(val[0].shape[-1])
            tier = transfer_tier(self._tier_stats.get(f"{leaf}:{key}"), cap)
            if tier is None:
                sizes += [None] * n_leaves
            elif codec == "rle2":
                sizes += [(-1, tier), (-2, tier), None]
            else:
                sizes += [(-1, tier), (-1, tier), None]
        return tuple(sizes)

    def _update_run_stats(self, leaf: str, out, pipe: LeafPipeline) -> None:
        from ...ops.rle import PAL_K
        for key in ("state_imgs_packed", "option_imgs_packed",
                    "grid_img_packed"):
            if key not in out:
                continue
            cap = (pipe.grid_budget if key == "grid_img_packed"
                   else pipe.frame_budget)
            val = out[key]
            if len(val) in (7, 9, 11):  # per-frame AVERAGE totals
                v5 = len(val) == 11          # (see _shrink_sizes)
                v4 = len(val) == 9
                base = 6 if v5 else (5 if v4 else 4)
                cnt = np.asarray(val[base])
                nc = np.asarray(val[base + 1])
                ec = np.asarray(val[base + 2])
                F = max(cnt.size, 1)
                stats = [("T", int(cnt.sum())),
                         ("P", int(np.minimum(nc, PAL_K).sum())),
                         ("E", int(ec.sum()))]
                if v4 or v5:
                    stats.append(("X", int(np.asarray(val[base + 3]).sum())))
                if v5:
                    # bitmask bytes quantize per frame: ceil(c/8), with c
                    # CLAMPED to the frame run budget — the device ships
                    # ceil(min(cnt,cap)/8) bytes, so overflow-heavy frames
                    # must not inflate the B tier past what ever travels
                    stats.append(("B", int((
                        (np.minimum(cnt, cap) + 7) // 8).sum())))
                    stats.append(("S", int(np.asarray(val[10]).sum())))
                for suf, tot in stats:
                    k = f"{leaf}:{key}:{suf}"
                    self._run_stats[k] = max(self._run_stats.get(k, 0.0),
                                             tot / F)
            else:
                c = int(np.asarray(val[2]).max())
                k = f"{leaf}:{key}"
                self._run_stats[k] = max(self._run_stats.get(k, 0), c)

    def _note_overflow(self, leaf: str, why: dict) -> None:
        """Self-healing transfer tiers.  `why` is the per-stream overflow
        attribution ({'grid'/'state'/'opt': {'T'/'E'/'P'/'X'/'B'/'S': n}}).
        A stream that overflows TIER_REFREEZE_AFTER consecutive batches has
        its tier re-frozen mid-run at the observed demand — with geometric
        escalation (1.5x the old frozen stat) so a bursty stream whose
        max-seen AVERAGE is stable still converges to a big-enough tier (or
        to travel-whole) in a few batches instead of paying raw-frame
        fallbacks for the rest of the run."""
        hit = set()
        for name, reasons in why.items():
            pkey = _STREAM_PKEY[name]
            for suf, n in reasons.items():
                if n <= 0:
                    continue
                skey = f"{leaf}:{pkey}:{suf}"
                hit.add(skey)
                streak = self._overflow_streak.get(skey, 0) + 1
                self._overflow_streak[skey] = streak
                if streak < TIER_REFREEZE_AFTER:
                    continue
                old = self._tier_stats.get(skey)
                if old is None:
                    # tier was already travel-whole: the DEVICE budget
                    # overflowed, which no transfer tier can fix
                    continue
                demand = self._run_stats.get(skey, 0.0)
                new = max(demand, old * 1.5)
                self._tier_stats[skey] = new
                # remember the pathology across runs too (freeze at
                # generate_ids entry copies _run_stats)
                self._run_stats[skey] = max(self._run_stats.get(skey, 0.0),
                                            new)
                self._overflow_streak[skey] = 0
                self.tiers_refrozen += 1
                logger.info("tier_refrozen %s: %.1f -> %.1f avg/frame "
                            "(batch %d)", skey, old, new,
                            self._batch_ordinal)
        # a clean batch for a stream breaks its streak (overflow must be
        # CONSECUTIVE to trigger a re-freeze)
        for k in list(self._overflow_streak):
            if k.startswith(f"{leaf}:") and k not in hit:
                self._overflow_streak[k] = 0

    def _clear_overflow_streaks(self, leaf: str) -> None:
        for k in list(self._overflow_streak):
            if k.startswith(f"{leaf}:"):
                self._overflow_streak[k] = 0

    def _export_batch(self, leaf: str, pipe: LeafPipeline, chunk, out, metas):
        import jax
        self._batch_ordinal += 1
        if isinstance(out, tuple):
            # coalesced form from generate_ids: ONE host transfer for the
            # blob, then reconstruct the output tree.  Image tensors stay
            # FULL batch — batch padding is sliced off as views AFTER
            # decode, so the ring buffers keep stable full-batch shapes
            # (shared across every same-L leaf) instead of one shape per
            # ragged tail.  Raw device handles stay full for the same
            # reason (and sharded dedup needs even shards).
            blob, treedef, specs, raw, n_real = out
            blob_np = np.asarray(blob)
            self.transfer_bytes += blob_np.nbytes
            full = (_split_flat if blob_np.ndim == 1
                    else _split_blob)(blob_np, treedef, specs)
            out = {k: (v if k.endswith("_packed")
                       else jax.tree.map(lambda a: a[:n_real], v))
                   for k, v in full.items()}
            out.update(raw)
            out["_n_real"] = n_real
        self._update_run_stats(leaf, out, pipe)
        L = pipe.L
        O = self.cfg.num_options
        layout = pipe.layout
        # arrays were sliced to the real chunk length at dispatch time
        states_np = jax.tree.map(np.asarray, out["states"])
        options_np = jax.tree.map(np.asarray, out["options"])
        params_np = jax.tree.map(np.asarray, out["params"])
        grid_only = getattr(self.cfg, "grid_only", False)
        codec = getattr(self.cfg, "transfer_codec", "rle4d")
        n_real = out.get("_n_real", len(chunk))
        # rle2 exports straight from the run stream (fastpng_write_rle):
        # no host pixel tensor is ever materialized — only frames that
        # overflowed their (possibly shrunken) run capacity are fetched
        # raw, all of them in one gathered transfer per tensor
        direct = codec == "rle2" and "grid_img_packed" in out
        direct3 = (codec in _COMPACT_CODECS
                   and "grid_img_packed" in out
                   and len(out["grid_img_packed"]) in (7, 9, 11))
        delta3 = direct3 and codec in ("rle3d", "rle4d", "rle5d")
        state_imgs = option_imgs = grid_imgs = None
        over_grid = over_state = over_opt = None
        g_fr = s_fr = o_fr = None
        if direct3:
            # rle3: per-frame views into the compacted streams; frames
            # whose runs/escapes were truncated fetch raw, all in one
            # gathered transfer per tensor
            from ...ops.rle import Rle3Frames
            g_fr = Rle3Frames(out["grid_img_packed"], pipe.grid_budget)
            over_grid = _gather_frames(out["grid_img"],
                                       g_fr.overflow_indices(n_real))
            if not grid_only:
                s_fr = Rle3Frames(out["state_imgs_packed"],
                                  pipe.frame_budget, delta=delta3)
                o_fr = Rle3Frames(out["option_imgs_packed"],
                                  pipe.frame_budget, delta=delta3)
                over_state = _gather_frames(
                    out["state_imgs"], s_fr.overflow_indices(n_real * L))
                over_opt = _gather_frames(
                    out["option_imgs"], o_fr.overflow_indices(n_real * O))
            for m in (over_grid, over_state, over_opt):
                if m:
                    self.transfer_bytes += sum(a.nbytes for a in m.values())
                    self.overflow_frames += len(m)
            if over_grid or over_state or over_opt:
                # per-stream attribution: which shrunken slice got cut
                why = {n: fr.overflow_reasons(f)
                       for n, fr, f in (("grid", g_fr, n_real),
                                        ("state", s_fr, n_real * L),
                                        ("opt", o_fr, n_real * O))
                       if fr is not None}
                counts = {n: len(m) for n, m in (("grid", over_grid),
                                                 ("state", over_state),
                                                 ("opt", over_opt)) if m}
                logger.info("overflow fallback %s: %s", counts,
                            {n: w for n, w in why.items() if w})
                self.overflow_events.append((self._batch_ordinal, counts))
                self._note_overflow(leaf, why)
            else:
                self._clear_overflow_streaks(leaf)
        elif direct:
            from ...io.transfer import overflow_pixels
            over_grid = overflow_pixels(
                out["grid_img_packed"], out["grid_img"], n_real)
            if not grid_only:
                over_state = overflow_pixels(
                    out["state_imgs_packed"], out["state_imgs"],
                    n_real * L)
                over_opt = overflow_pixels(
                    out["option_imgs_packed"], out["option_imgs"],
                    n_real * O)
            for m in (over_grid, over_state, over_opt):
                if m:
                    self.transfer_bytes += sum(a.nbytes for a in m.values())
                    self.overflow_frames += len(m)
        else:
            # decode into ring buffers: fresh 100 MB state/option tensors
            # cost ~9 s/batch in first-touch page faults on this host.  A
            # wrapped buffer may still back in-flight PNG writes -> drain
            # the pool BEFORE decoding into it (with 3 slots the writes
            # are from two batches ago and long since finished).
            bufs, wrapped = {}, False
            keys = [("grid", out["grid_img"].shape)]
            if not grid_only and "state_imgs_packed" in out:
                keys += [("state", out["state_imgs"].shape),
                         ("option", out["option_imgs"].shape)]
            for name, shape in keys:
                bufs[name], w = self._bufs.acquire(shape)
                wrapped |= w
            if wrapped:
                self._pool.drain()
            if "grid_img_packed" in out:
                grid_imgs = _unpack_images(out["grid_img_packed"],
                                           out["grid_img"], codec,
                                           out=bufs["grid"])[:n_real]
            else:
                grid_imgs = np.asarray(out["grid_img"])[:n_real]
            if grid_only:
                state_imgs = option_imgs = None
            elif "state_imgs_packed" in out:
                state_imgs = _unpack_images(out["state_imgs_packed"],
                                            out["state_imgs"], codec,
                                            out=bufs["state"])[:n_real]
                option_imgs = _unpack_images(out["option_imgs_packed"],
                                             out["option_imgs"], codec,
                                             out=bufs["option"])[:n_real]
            else:
                state_imgs = np.asarray(out["state_imgs"])[:n_real]
                option_imgs = np.asarray(out["option_imgs"])[:n_real]
        perms = np.asarray(out["perm"])
        correct = np.asarray(out["correct_index"])

        handle = out.get("_keep_handle")
        if "_keep" in out:
            # blob-carried keep mask (single-device dedup): no extra fetch
            keep = np.asarray(out["_keep"]).reshape(-1)[:n_real].astype(bool)
        elif handle is not None:
            keep = self._corpus.resolve(handle)
        else:
            keep = np.ones(len(chunk), bool)
        # per-sample grid pHash (16 hex chars) rides along in the meta so a
        # later merge can dedup ACROSS independent hosts without any
        # lockstep collective (cli.merge_host_indexes)
        phashes = np.asarray(out["grid_phash"])

        if direct or direct3:
            gh, gw = out["grid_img"].shape[-3], out["grid_img"].shape[-2]
            if not grid_only:
                fh, fw = (out["state_imgs"].shape[-3],
                          out["state_imgs"].shape[-2])
        if direct:
            g_ln, g_co, g_cnt = out["grid_img_packed"]
            g_cap = g_ln.shape[-1]
            if not grid_only:
                s_ln, s_co, s_cnt = out["state_imgs_packed"]
                o_ln, o_co, o_cnt = out["option_imgs_packed"]
                s_cap, o_cap = s_ln.shape[-1], o_ln.shape[-1]

        for b, (sid, path, use_grid) in enumerate(chunk):
            if not keep[b]:
                # near-duplicate of an earlier sample: record, don't export
                metas[sid] = {"id": int(sid), "category_path": list(path),
                              "rule": leaf, "duplicate": True}
                continue
            sample_dir = os.path.join(self.samples_dir, f"sample_{sid:06d}")
            ensure_dir(sample_dir)
            grid_path = os.path.join(self.grids_dir, f"grid_{sid:06d}.png")

            perm = perms[b]
            if not grid_only and delta3:
                # delta streams: one pool task materializes the sample's
                # state chain (t vs t-1) + options (vs state L-1) and
                # writes all its PNGs; raw overflow fetches splice in as
                # exact bases
                self._pool.submit(_write_delta_sample, s_fr, o_fr,
                                  over_state, over_opt, b, L, O, fh, fw,
                                  sample_dir, perm)
                self._pool.submit_png(os.path.join(sample_dir, "query.png"),
                                      layout.query_patch)
            elif not grid_only:
                for t in range(L):
                    spath = os.path.join(sample_dir, f"state_{t}.png")
                    if direct3:
                        fi = b * L + t
                        if fi in over_state:
                            self._pool.submit_png(spath, over_state[fi])
                        else:
                            self._pool.submit_png_rle3(spath, s_fr, fi,
                                                       fh, fw)
                    elif not direct:
                        self._pool.submit_png(spath, state_imgs[b, t])
                    elif int(s_cnt[b, t]) > s_cap:
                        self._pool.submit_png(spath, over_state[b * L + t])
                    else:
                        self._pool.submit_png_rle(
                            spath, s_ln[b, t], s_co[b, t],
                            int(s_cnt[b, t]), fh, fw)
                # distractor files keep their pre-shuffle index j (reference
                # writes option_j.png at generation time, src/generator.py:500)
                for pos in range(O):
                    src = int(perm[pos])
                    name = ("proto_true_next.png" if src == 0 else
                            f"option_{src}.png")
                    opath = os.path.join(sample_dir, name)
                    if direct3:
                        fi = b * O + pos
                        if fi in over_opt:
                            self._pool.submit_png(opath, over_opt[fi])
                        else:
                            self._pool.submit_png_rle3(opath, o_fr, fi,
                                                       fh, fw)
                    elif not direct:
                        self._pool.submit_png(opath, option_imgs[b, pos])
                    elif int(o_cnt[b, pos]) > o_cap:
                        self._pool.submit_png(opath, over_opt[b * O + pos])
                    else:
                        self._pool.submit_png_rle(
                            opath, o_ln[b, pos], o_co[b, pos],
                            int(o_cnt[b, pos]), fh, fw)
                self._pool.submit_png(os.path.join(sample_dir, "query.png"),
                                      layout.query_patch)
            if direct3:
                if b in over_grid:
                    self._pool.submit_png(grid_path, over_grid[b])
                else:
                    # pre-overlay canvas + exact host overlay re-blend,
                    # same contract as the rle2 path below
                    self._pool.submit_png_rle3(
                        grid_path, g_fr, b, gh, gw,
                        overlay=(layout.overlay_rgb_u8, layout.overlay_a8))
            elif not direct:
                self._pool.submit_png(grid_path, grid_imgs[b])
            elif int(g_cnt[b]) > g_cap:
                # raw fallback frames are the FULL grid (overlay already
                # blended on device with the same integer math)
                self._pool.submit_png(grid_path, over_grid[b])
            else:
                # the rle2 stream carries the pre-overlay canvas; the C
                # encoder re-applies the static overlay exactly
                self._pool.submit_png_rle(
                    grid_path, g_ln[b], g_co[b], int(g_cnt[b]), gh, gw,
                    overlay=(layout.overlay_rgb_u8, layout.overlay_a8))

            # meta/coco build + write is a pool task — metas[sid] holds a
            # Future that generate_ids resolves after the final drain
            metas[sid] = self._pool.submit_task(
                _meta_task, sid, leaf, path, self.out_dir, sample_dir,
                grid_path, states_np, options_np, params_np, b, perm,
                int(correct[b]), bool(use_grid), self.cfg.grid_size,
                self.cfg.canvas_size, layout, self.cfg.seed,
                bytes(phashes[b]).hex(), grid_only,
                self.cfg.export_json, self.cfg.export_coco,
                getattr(self.cfg, "pretty_json", False))

    def close(self):
        from ...utils.cache import save_run_stats
        save_run_stats(self._stats_name, self._run_stats)
        self._pool.close()
