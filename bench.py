#!/usr/bin/env python3
# bench.py — end-to-end throughput benchmark (parseable JSON lines to stdout).
"""Measures full RPM sample generation throughput (device generation +
render + grid compose + PNG/JSON export) on one GPU.

Baseline: the reference CPU pipeline (reference src/cli.py) measured at
0.202 samples/s (32-sample run, single CPU core).  The reference publishes
no benchmark numbers of its own (BASELINE.md).

Stages (ordered headline-first; the byte-heavy full-export stages run LAST
and are budget-gated so a short window can only cost the least-important
numbers):
  1. warmup (timed; `warmup_s` + `aot_entries_before` make compile-polluted
     runs distinguishable from slow ones)
  2. device-only samples/s (north-star: BASELINE.json images/sec/chip)
  3. e2e grid-only export (the composed puzzle is the training artifact)
  4. the literal BASELINE scenario: ~1k samples, dedup on, all 9 rule
     leaves weighted (reference README.md:8 — the <10 s / 1k target)
  5. combined-dataset BASELINE: 1k RPM (dedup) + 100 multigraph images
     (dedup) in one timed window — the reference's full ~1k-sample
     dataset claim spans both pipelines
  6. multigraph device + e2e rates
  7. e2e full export (state/option/grid PNGs + meta/coco JSON)
  8. the BASELINE scenario, full-export variant

Every e2e stage reports measured device->host bytes/sample beside the
rate.  `*_sps_at_10mbps` = min(device rate, 10 MB/s / bytes_per_sample)
projects each e2e figure onto a fixed link speed.

Evidence survives a kill: the child prints a FULL cumulative JSON line to
stdout after every completed stage and checkpoints it to a file; the
parent (which never imports jax, so the child is the only process on the
card) emits the checkpoint on SIGTERM/SIGINT or at its watchdog timeout.
The child refuses to run unless the default device is a GPU, and records
the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

REFERENCE_BASELINE_SPS = 0.202

N_WARM = int(os.environ.get("BENCH_N_WARM", "128"))
N_TIMED = int(os.environ.get("BENCH_N_TIMED", "512"))
                 # timed window: big enough that the per-leaf ragged tail
                 # batch (padded to batch_size) doesn't distort bytes/rate
N_BASELINE = int(os.environ.get("BENCH_N_BASELINE", "1024"))

# All 9 leaves weighted like the production default (uniform): every
# pipeline's throughput is measured, none asserted.  Compiles are one-time
# under the persistent XLA cache.
BENCH_WEIGHTS = {"平移": 1.0, "旋转": 1.0, "翻转(镜像)": 1.0, "组合": 1.0,
                 "直接叠加": 1.0, "去同存异": 1.0, "去异存同": 1.0,
                 "单一遍历": 1.0, "位置遍历": 1.0}

# Reference multigraph pipeline baseline, MEASURED on this host
# (tools/measure_mg_baseline.py, 2026-08-17) with a numpy shapely shim
# (shapely isn't installed; tools/shapely_shim implements the API subset
# the reference uses) and the math.lg10->log10 typo patched: seeds 0-14
# run at ~1.2 imgs/s (p50 0.13 s/task), but the adjacent-placement
# search is heavy-tailed — seed 15 alone took 333 s (the reference's
# unbounded 180-angle x distance-ladder sweep), dragging the 16-sample
# mean to 0.046 imgs/s.  We use the typical-rate 1.2 as the denominator
# (the favorable-to-the-reference choice).
REFERENCE_MG_BASELINE_IPS = 1.2  # measured typical rate (see above)

# Wall-clock budget for the child.  Once elapsed time crosses it,
# remaining stages are skipped (their fields stay absent and are named in
# `skipped_stages`).  Must leave margin under BENCH_TIMEOUT_S, which must
# itself sit under any external time limit.
BENCH_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "780"))
# The byte-heavy full-export stages only start if at least this much of
# the budget remains — they are the least-important numbers.
FULL_EXPORT_MIN_REMAINING_S = 240.0
# Below this measured link speed the full-export timed window shrinks
# (288 ids still gives every leaf a full batch-32 group on average) and
# the 1024-sample full-export run is skipped outright.
SLOW_LINK_MBPS = 2.0

# Hard wall for the watchdog child (the parent never imports jax, so the
# child is the only process on the card).
BENCH_TIMEOUT_S = float(os.environ.get("BENCH_TIMEOUT_S", "1000"))

_CHILD_FLAG = "--child"


# --------------------------------------------------------------------------
# parent side: watchdog (never imports jax)
# --------------------------------------------------------------------------

def _emit(out: dict) -> int:
    print(json.dumps(out), flush=True)
    return 0


def _error_json(msg: str, partial: dict | None = None) -> dict:
    out = {"metric": "rpm_samples_per_sec_device", "value": 0.0,
           "unit": "samples/s", "vs_baseline": 0.0, "error": msg}
    if partial:
        partial.pop("error", None)
        out.update({k: v for k, v in partial.items()
                    if k not in ("metric", "unit")})
        # keep any real measured headline the child checkpointed
        if partial.get("value"):
            out["value"] = partial["value"]
            out["vs_baseline"] = partial.get("vs_baseline", 0.0)
    return out


def _read_partial(res_path: str) -> dict | None:
    try:
        with open(res_path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def main() -> int:
    res_path = tempfile.mktemp(prefix="rig_bench_res_", suffix=".json")
    env = dict(os.environ)
    env["BENCH_RES_PATH"] = res_path
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), _CHILD_FLAG],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)))

    # An external kill (driver timeout -> SIGTERM) must still yield the
    # completed stages: dump the child's checkpoint file and exit 0.  The
    # child has been printing cumulative lines to the shared stdout all
    # along, so this is the second layer, not the only one.
    def _on_signal(signum, frame):  # pragma: no cover - signal path
        partial = _read_partial(res_path)
        partial = partial or {}
        partial.pop("complete", None)
        _emit(_error_json(f"killed by signal {signum} "
                          "(partial results attached)", partial))
        try:
            proc.terminate()
        except OSError:
            pass
        os._exit(0)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    try:
        rc = proc.wait(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rc = -1
        msg = f"bench child hit hard timeout {BENCH_TIMEOUT_S:.0f}s"
    else:
        msg = f"bench child exited rc={rc}"

    partial = _read_partial(res_path)
    try:
        os.unlink(res_path)
    except OSError:
        pass

    if rc == 0 and partial is not None and partial.get("complete"):
        partial.pop("complete", None)
        return _emit(partial)
    if partial is not None:
        partial.pop("complete", None)
        return _emit(_error_json(msg + " (partial results attached)",
                                 partial))
    return _emit(_error_json(msg + " (no partial results)"))


# --------------------------------------------------------------------------
# child side: the actual measurements (checkpoints to BENCH_RES_PATH and
# prints a cumulative JSON headline line after every stage)
# --------------------------------------------------------------------------

def _timed_export(gen, warm_ids, timed_ids, **kw):
    """TWO untimed passes, then a timed pass.  The first warm pass runs
    with cold transfer tiers (full-capacity streams) and converges the
    run statistics; tiers refreeze at every generate_ids entry, so the
    SECOND pass runs at the converged tiers and compiles their shrunken
    coalesce programs + any overflow-gather buckets outside the timed
    window.
    Returns (samples/s, bytes/sample, overflow frame count, metas)."""
    gen.generate_ids(warm_ids, **kw)
    gen._pool.drain()
    gen.generate_ids(warm_ids, **kw)
    gen._pool.drain()
    b0 = gen.transfer_bytes
    o0 = getattr(gen, "overflow_frames", 0)
    t0 = time.time()
    metas = gen.generate_ids(timed_ids, **kw)
    gen._pool.drain()
    dt = time.time() - t0
    bps = (gen.transfer_bytes - b0) / max(len(metas), 1)
    over = getattr(gen, "overflow_frames", 0) - o0
    return len(metas) / dt, bps, over, metas


class _Checkpointer:
    """Builds the output JSON incrementally; persists to BENCH_RES_PATH
    after every update AND (on stage boundaries) prints the cumulative
    headline line to stdout, so an external kill at any moment leaves the
    completed stages' numbers both on disk and in the captured output."""

    def __init__(self, path: str | None):
        self.path = path
        self.t0 = time.time()
        self.out = {"metric": "rpm_samples_per_sec_device", "value": 0.0,
                    "unit": "samples/s", "vs_baseline": 0.0}

    def update(self, **fields):
        self.out.update(fields)
        self.save()

    def stage(self, name: str, **fields):
        """Stage boundary: update + print the cumulative headline line."""
        fields["last_stage"] = name
        fields["elapsed_s"] = round(time.time() - self.t0, 1)
        self.update(**fields)
        line = {k: v for k, v in self.out.items() if k != "complete"}
        print(json.dumps(line), flush=True)

    def over_budget(self, stage: str, min_remaining: float = 0.0) -> bool:
        remaining = BENCH_BUDGET_S - (time.time() - self.t0)
        if remaining < max(min_remaining, 0.0):
            print(f"bench: budget exceeded ({remaining:.0f}s left), "
                  f"skipping {stage}", file=sys.stderr, flush=True)
            skipped = list(self.out.get("skipped_stages", [])) + [stage]
            self.update(skipped_stages=skipped)
            return True
        return False

    def save(self):
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.out, f)
        os.replace(tmp, self.path)


def _aot_entries() -> int:
    from reasoning_image_generation_tpu.utils.cache import cache_dir
    try:
        return len(os.listdir(os.path.join(cache_dir(), "aot")))
    except OSError:
        return 0


def _run_rpm_headline(ck: _Checkpointer, state: dict):
    """Warmup + device rate + link probe + grid-only e2e + the 1k-dedup
    grid-only BASELINE window.  These carry every headline number; they run
    first so an external kill can only cost the byte-heavy tail stages."""
    import numpy as np
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
    from reasoning_image_generation_tpu.models.rpm.pipeline import sample_keys

    out_dir = state["out_dir"]
    ck.update(aot_entries_before=_aot_entries())

    # sparse_transfer stays off for the DEVICE-rate runs (the codec
    # costs ~2x device time and the headline metric is device
    # samples/s); the e2e runs below use their own codec-enabled
    # pipelines because the device->host link is the e2e bottleneck
    # on this host (measured: raw link ~5-20 MB/s and varying).
    cfg = GenConfig(out_dir=out_dir, seed=123, batch_size=32,
                    category_weights=dict(BENCH_WEIGHTS))
    gen = RPMGeneratorTPU(cfg)
    ids = list(range(N_WARM))
    ids2 = list(range(N_WARM, N_WARM + N_TIMED))
    print("bench: warming up (compiles)...", file=sys.stderr, flush=True)
    t0 = time.time()
    gen.warmup(ids)
    ck.stage("warmup", warmup_s=round(time.time() - t0, 1))

    # the north-star metric (BASELINE.json): rendered puzzle
    # samples/sec/chip at 512^2, on-device.  Latency-amortized
    # (10 dispatches per sync); the per-dispatch-blocking number is
    # reported alongside
    # so methodology changes can't masquerade as perf deltas.
    # Measured over N_TIMED ids so every leaf contributes at least one
    # FULL batch (with only N_WARM ids the 9-leaf groups are all
    # ragged and padding gets billed as dead time, ~2x understatement).
    print("bench: device-only run...", file=sys.stderr, flush=True)
    device_sps = gen.measure_device_rate(ids2, iters=10)
    ck.update(value=round(device_sps, 3),
              vs_baseline=round(device_sps / REFERENCE_BASELINE_SPS, 2))
    ck.stage("device_only", device_sps_blocking=round(
        gen.measure_device_rate(ids2, iters=10, blocking=True), 3))
    state["device_sps"] = device_sps

    # quantify the link: raw device->host MB/s for one batch's images
    leaf, entries = next(iter(gen._sample_assignments(ids).items()))
    pipe = gen._pipeline(leaf)
    chunk = entries[:cfg.batch_size]
    pad = [e[0] for e in chunk] + [chunk[0][0]] * (cfg.batch_size - len(chunk))
    ug = np.asarray([e[2] for e in chunk] +
                    [False] * (cfg.batch_size - len(chunk)))
    out = pipe(sample_keys(cfg.seed or 0, np.asarray(pad)), ug)
    _ = np.asarray(out["grid_img"].reshape(-1)[0])
    t0 = time.time()
    nbytes = sum(np.asarray(out[k]).nbytes
                 for k in ("state_imgs", "option_imgs", "grid_img"))
    link_mbps = nbytes / max(time.time() - t0, 1e-9) / 1e6
    ck.stage("link_probe", host_link_mbps=round(link_mbps, 2))
    state["link_mbps"] = link_mbps
    gen.close()

    idsk = list(range(10_000, 10_000 + N_BASELINE))

    # grid-only export (the composed puzzle is the training artifact;
    # per-frame images never cross the link).  Runs FIRST among the e2e
    # stages: it carries the headline BASELINE target and is ~6x lighter
    # on the link.
    print("bench: grid-only e2e run...", file=sys.stderr, flush=True)
    cfg3 = GenConfig(out_dir=out_dir + "_g", seed=123, batch_size=32,
                     category_weights=dict(BENCH_WEIGHTS),
                     sparse_transfer=True, grid_only=True)
    gen3 = RPMGeneratorTPU(cfg3)
    gen3.warmup(ids + ids2)
    g_sps, g_bps, g_over, _ = _timed_export(gen3, ids, ids2)
    ck.stage("grid_only_e2e",
             e2e_grid_only_sps=round(g_sps, 3),
             grid_bytes_per_sample=round(g_bps),
             grid_only_sps_at_10mbps=round(
                 min(device_sps, 10e6 / max(g_bps, 1)), 1),
             grid_overflow_frames=g_over)

    # the literal BASELINE scenario, grid-only: ~1k samples, dedup on
    # (reference README.md:8; <10 s target).  Untimed mini-pass first:
    # compiles the dedup_append_step program (CorpusDedup quantizes
    # capacity to >=4096, so the 64-id warm and the 1k run share one
    # compiled shape).
    gen3.generate_ids(ids[:64], dedup=True)
    gen3._pool.drain()
    print("bench: 1k dedup grid-only run...", file=sys.stderr, flush=True)
    t0 = time.time()
    metas = gen3.generate_ids(idsk, dedup=True)
    gen3._pool.drain()
    ck.stage("baseline_1k_grid",
             baseline_1k_grid_s=round(time.time() - t0, 2),
             baseline_1k_grid_kept=sum(
                 1 for m in metas
                 if not m.get("duplicate") and not m.get("error")))
    gen3.close()
    shutil.rmtree(out_dir + "_g", ignore_errors=True)


def _run_rpm_full_export(ck: _Checkpointer, state: dict):
    """The byte-heavy full-export stages (state/option/grid PNGs +
    meta/coco JSON).  Run LAST and budget-gated: they carry no headline
    target."""
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU

    out_dir = state["out_dir"]
    device_sps = state.get("device_sps", 0.0)
    link_mbps = state.get("link_mbps", 0.0)
    slow_link = link_mbps < SLOW_LINK_MBPS
    ids = list(range(N_WARM))
    ids2 = list(range(N_WARM, N_WARM + N_TIMED))

    if ck.over_budget("e2e_full", FULL_EXPORT_MIN_REMAINING_S):
        return
    print("bench: e2e full-export run...", file=sys.stderr, flush=True)
    cfg2 = GenConfig(out_dir=out_dir + "_s", seed=123, batch_size=32,
                     category_weights=dict(BENCH_WEIGHTS),
                     sparse_transfer=True)
    gen2 = RPMGeneratorTPU(cfg2)
    timed2 = ids2[:288] if slow_link else ids2
    gen2.warmup(ids + timed2)
    e_sps, e_bps, e_over, _ = _timed_export(gen2, ids, timed2)
    ck.stage("e2e_full",
             e2e_samples_per_sec=round(e_sps, 3),
             e2e_vs_baseline=round(e_sps / REFERENCE_BASELINE_SPS, 2),
             e2e_bytes_per_sample=round(e_bps),
             e2e_sps_at_10mbps=round(
                 min(device_sps, 10e6 / max(e_bps, 1)), 1),
             e2e_overflow_frames=e_over)

    # BASELINE scenario, full export
    if slow_link:
        ck.update(skipped_stages=list(ck.out.get("skipped_stages", []))
                  + ["baseline_1k_full(slow_link)"])
    elif not ck.over_budget("baseline_1k_full", FULL_EXPORT_MIN_REMAINING_S):
        gen2.generate_ids(ids[:64], dedup=True)  # compile dedup step
        gen2._pool.drain()
        print("bench: 1k dedup full-export run...", file=sys.stderr,
              flush=True)
        idsk = list(range(10_000, 10_000 + N_BASELINE))
        b0 = gen2.transfer_bytes
        t0 = time.time()
        metas = gen2.generate_ids(idsk, dedup=True)
        gen2._pool.drain()
        ck.stage("baseline_1k_full",
                 baseline_1k_full_s=round(time.time() - t0, 2),
                 baseline_1k_full_bytes_per_sample=round(
                     (gen2.transfer_bytes - b0) / N_BASELINE),
                 baseline_1k_full_kept=sum(
                     1 for m in metas
                     if not m.get("duplicate") and not m.get("error")))
    gen2.close()
    shutil.rmtree(out_dir + "_s", ignore_errors=True)


def _run_multigraph(ck: _Checkpointer, n_batches: int = 3, B: int = 8,
                    dpi: int = 200):
    """Multigraph (single-image) pipeline throughput: device imgs/s
    (latency-amortized) and steady-state e2e imgs/s incl. PNG+JSON export
    at dpi 200 (the reference's second pipeline,
    reference multigraph_generation/cli.py:30-72)."""
    import numpy as np
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        build_scene_batch)

    from reasoning_image_generation_tpu.models.multigraph.renderer import (
        render_scene_batch as render)

    gen = GeometryGeneratorTPU()

    seeds = list(range(B))
    modes = ["adjacent"] * B
    batch, _metas = build_scene_batch(seeds, modes, gen.global_scale)

    print("bench: multigraph device run...", file=sys.stderr, flush=True)
    imgs = render(batch, dpi=dpi)
    _ = np.asarray(imgs.reshape(-1)[0])  # compile + sync
    iters = 10
    t0 = time.perf_counter()
    for _i in range(iters):
        imgs = render(batch, dpi=dpi)
    _ = np.asarray(imgs.reshape(-1)[0])
    device_ips = B * iters / (time.perf_counter() - t0)
    ck.stage("mg_device",
             mg_imgs_per_sec_device=round(device_ips, 3),
             mg_vs_baseline=round(device_ips / REFERENCE_MG_BASELINE_IPS, 2))

    print("bench: multigraph e2e run...", file=sys.stderr, flush=True)
    out_dir = tempfile.mkdtemp(prefix="rig_bench_mg_")

    def run_batches(tag, lo):
        # pipelined driver (generate_batches): what the CLI runs
        s = [lo + i for i in range(n_batches * B)]
        gen.generate_batches(
            s, modes * n_batches,
            [os.path.join(out_dir, f"{tag}{i}_adjacent.png") for i in s],
            [os.path.join(out_dir, f"{tag}{i}_adjacent.json") for i in s],
            dpi=dpi, batch_size=B)
        gen._pool.drain()
        return len(s)

    try:
        # untimed warmup passes: the first converges transfer-tier
        # statistics (cold tiers, full-capacity streams), the second
        # compiles the shrunken coalesce programs at the converged tiers —
        # steady state is what a production run sees
        run_batches("w", 0)
        run_batches("x", 500)
        b0 = gen.transfer_bytes
        t0 = time.time()
        n = run_batches("t", 1000)
        e2e_ips = n / (time.time() - t0)
        bpi = (gen.transfer_bytes - b0) / n
        ck.stage("mg_e2e",
                 mg_e2e_imgs_per_sec=round(e2e_ips, 3),
                 mg_bytes_per_img=round(bpi))
    finally:
        gen.close()
        shutil.rmtree(out_dir, ignore_errors=True)


def _run_combined_baseline(ck: _Checkpointer, n_rpm: int | None = None,
                           n_mg: int = 100):
    """The full-dataset BASELINE scenario in ONE timed window: ~1k RPM
    sequence puzzles (grid export, corpus dedup) + ~100 multigraph
    single-image samples (corpus dedup) — the reference's ≈1,000-sample
    dataset claim (reference README.md:8) spans both pipelines."""
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)

    print("bench: combined-dataset 1k run...", file=sys.stderr, flush=True)
    out_dir = tempfile.mkdtemp(prefix="rig_bench_ds_")
    n_rpm = n_rpm if n_rpm is not None else N_BASELINE
    try:
        cfg = GenConfig(out_dir=out_dir, seed=123, batch_size=32,
                        category_weights=dict(BENCH_WEIGHTS),
                        sparse_transfer=True, grid_only=True)
        rgen = RPMGeneratorTPU(cfg)
        mgen = GeometryGeneratorTPU()
        # warm both (compiles + tiers) outside the timed window
        rgen.warmup(list(range(64)))
        rgen.generate_ids(list(range(64)), dedup=True)
        rgen._pool.drain()
        mg_bs = 50                      # 2 transfers for the 100-img half
        mg_ids = list(range(n_mg))
        mg_modes = [["nested", "adjacent", "intersecting", "random"][i % 4]
                    for i in range(n_mg)]
        png = [os.path.join(out_dir, f"w{i}_{m}.png")
               for i, m in zip(mg_ids, mg_modes)]
        js = [os.path.join(out_dir, f"w{i}_{m}.json")
              for i, m in zip(mg_ids, mg_modes)]
        mgen.generate_batches(mg_ids[:mg_bs], mg_modes[:mg_bs],
                              png[:mg_bs], js[:mg_bs],
                              dpi=200, batch_size=mg_bs, dedup=True)
        mgen._pool.drain()

        # the two pipelines overlap inside the window, as a production
        # dataset build would run them: mg's few small-batch transfers
        # interleave with the RPM stream instead of serializing after it
        # (mg scene build is host-side numpy, so
        # the thread mostly fills RPM's device-wait gaps)
        recs = []

        def _mg_half():
            p = [os.path.join(out_dir, f"t{i}_{m}.png")
                 for i, m in zip(mg_ids, mg_modes)]
            j = [os.path.join(out_dir, f"t{i}_{m}.json")
                 for i, m in zip(mg_ids, mg_modes)]
            recs.extend(mgen.generate_batches(
                mg_ids, mg_modes, p, j,
                dpi=200, batch_size=mg_bs, dedup=True))

        t0 = time.time()
        mg_thread = threading.Thread(target=_mg_half, daemon=True)
        mg_thread.start()
        metas = rgen.generate_ids(
            list(range(20_000, 20_000 + n_rpm)), dedup=True)
        mg_thread.join()
        rgen._pool.drain()
        mgen._pool.drain()
        wall = time.time() - t0
        kept_rpm = sum(1 for m in metas
                       if not m.get("duplicate") and not m.get("error"))
        kept_mg = sum(1 for r in recs if not getattr(r, "duplicate", False))
        ck.stage("combined_dataset",
                 dataset_wall_s=round(wall, 2),
                 dataset_kept=kept_rpm + kept_mg,
                 dataset_n=n_rpm + n_mg)
        rgen.close()
        mgen.close()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _device_or_raise(ck: _Checkpointer) -> None:
    """The measurement runs on a GPU or not at all: record the device as
    JAX reports it and the card's name and power limit."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU, the default device is "
                           f"{dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"bench: {card}", file=sys.stderr, flush=True)
    ck.update(device={"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, card=card)


def child_main() -> int:
    ck = _Checkpointer(os.environ.get("BENCH_RES_PATH"))
    _device_or_raise(ck)
    from reasoning_image_generation_tpu.cli import enable_compilation_cache
    enable_compilation_cache()

    state = {"out_dir": tempfile.mkdtemp(prefix="rig_bench_")}

    for attempt in range(2):
        try:
            _run_rpm_headline(ck, state)
            break
        except Exception as e:  # pragma: no cover
            import traceback
            traceback.print_exc()
            print(f"bench: rpm attempt {attempt} failed: {e}",
                  file=sys.stderr, flush=True)
            ck.update(rpm_error=str(e)[:300])
            time.sleep(10)

    # combined-dataset BASELINE runs BEFORE the mg rate stages: it carries
    # the <10 s full-dataset target (the single most important number) and
    # must land even if the driver window cuts the run short
    if not ck.over_budget("combined_dataset"):
        try:
            _run_combined_baseline(ck)
        except Exception as e:  # pragma: no cover
            import traceback
            traceback.print_exc()
            print(f"bench: combined baseline failed: {e}", file=sys.stderr,
                  flush=True)
            ck.update(skipped_stages=list(ck.out.get("skipped_stages", []))
                      + ["combined_dataset(error)"])

    if not ck.over_budget("multigraph"):
        try:
            _run_multigraph(ck)
        except Exception as e:  # pragma: no cover
            print(f"bench: multigraph failed: {e}", file=sys.stderr,
                  flush=True)
            ck.update(mg_imgs_per_sec_device=0.0, mg_e2e_imgs_per_sec=0.0,
                      mg_bytes_per_img=0, mg_vs_baseline=0.0)

    try:
        _run_rpm_full_export(ck, state)
    except Exception as e:  # pragma: no cover
        import traceback
        traceback.print_exc()
        print(f"bench: full-export failed: {e}", file=sys.stderr, flush=True)
        ck.update(skipped_stages=list(ck.out.get("skipped_stages", []))
                  + ["e2e_full(error)"])

    shutil.rmtree(state["out_dir"], ignore_errors=True)
    ck.update(complete=True)
    out = {k: v for k, v in ck.out.items() if k != "complete"}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if _CHILD_FLAG in sys.argv[1:]:
        sys.exit(child_main())
    sys.exit(main())
