# pipeline.py — per-leaf batched sample generation (one XLA program each).
"""End-to-end on-device generation of RPM samples.

Where the reference generates one sample at a time behind a process pool +
watchdog thread (reference src/generator.py:210-314, src/cli.py:85-129), this
pipeline generates a whole batch per rule leaf in a single jitted program:

  sample_prototype  ->  lax.scan over rule steps  ->  vectorized distractor
  candidates + structural-hash dedup  ->  option shuffle  ->  SDF render of
  every frame  ->  grid composition

The rule leaf is a *static* specialization (host groups sample ids by leaf),
so no lax.switch executes unused branches and sequence length L (6 for the
overlay triplet, 4 otherwise — reference src/generator.py:262) is static.

Distractor retry loops (reference src/generator.py:444-481, <=20 retries)
become K parallel candidates + first-accept selection against the running
set of structural hashes (the reference's frozenset dedup,
src/generator.py:149-177, becomes an order-independent element-hash sum).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...utils.config import GenConfig, OVERLAY_LEAVES, KIND_ID
from ...utils.state import ElementState, recompute_bbox_from_center
from ...ops.raster import render_frame
from ...ops.compose import GridLayout, build_layout, compose_grid
from ...ops.phash import phash
from ...ops.sparse import pack_batch
from .sampler import sample_prototype
from .rules import RULES, pack_state, concat_states

CIRCLE = KIND_ID["circle"]
# parallel distractor candidates per option slot; the first candidate is
# almost always structurally unique (fresh random params), so 4 covers the
# reference's <=20-retry budget in practice (src/generator.py:444-481)
N_CANDIDATES = 4


def seq_len_for(leaf: str) -> int:
    return 6 if leaf in OVERLAY_LEAVES else 4


def proto_n_for(leaf: str):
    """Initial element count per rule (reference src/generator.py:327-335)."""
    if leaf in ("单一遍历", "位置遍历"):
        return 2
    if leaf in ("平移", "旋转", "翻转(镜像)"):
        return 1
    return None  # randint(1, 3)


def _constrain_prototype(leaf: str, key, st: ElementState, W, H, grid_size=3):
    """Leaf-specific validity constraints.

    The reference *hangs* (and dies by watchdog timeout) when 旋转 draws a
    circle (src/rules.py:223-229) or 翻转(镜像) draws the center cell
    (src/rules.py:360-364); we make those samples valid instead.
    """
    if leaf == "旋转":
        # resample circle kinds into the other 10 kinds
        k = jax.random.randint(key, st.kind.shape, 0, 10)
        k = jnp.where(k >= CIRCLE, k + 1, k)
        new_kind = jnp.where(st.kind == CIRCLE, k, st.kind)
        # circles had angle forced 0; that is a valid angle for all kinds
        return st._replace(kind=new_kind)
    if leaf == "翻转(镜像)":
        cell_w, cell_h = W / grid_size, H / grid_size
        mid = grid_size // 2
        in_center = ((jnp.floor(st.cx / cell_w) == mid) &
                     (jnp.floor(st.cy / cell_h) == mid) & st.valid)
        # push offenders one cell left (wrapping), preserving in-cell offset
        new_cx = jnp.where(in_center, st.cx - cell_w, st.cx)
        new_cx = jnp.where(new_cx < 0, new_cx + W, new_cx)
        return st._replace(cx=new_cx)
    return st


def state_hash(st: ElementState) -> jnp.ndarray:
    """Order-independent structural hash of a frame (uint32).

    Replaces the reference's recursive frozenset keys
    (src/generator.py:149-177): quantized fields -> per-element polynomial
    hash -> sum over valid elements.
    """
    def q(x):
        return jnp.round(x).astype(jnp.uint32)

    fields = [
        st.kind.astype(jnp.uint32), q(st.size), q(st.cx), q(st.cy),
        q(st.angle * 8.0), st.fill.astype(jnp.uint32), q(st.stroke),
        q(st.color[..., 0]), q(st.color[..., 1]), q(st.color[..., 2]),
        q(st.bbox[..., 0]), q(st.bbox[..., 1]), q(st.bbox[..., 2]),
        q(st.bbox[..., 3]),
        st.flip_h.astype(jnp.uint32), st.flip_v.astype(jnp.uint32),
    ]
    h = jnp.full(st.kind.shape, 2166136261, jnp.uint32)
    for f in fields:
        h = h * jnp.uint32(16777619) + f
    h = jnp.where(st.valid, h | jnp.uint32(1), jnp.uint32(0))
    return jnp.sum(h, axis=-1, dtype=jnp.uint32)


def _random_subset(key, st: ElementState) -> ElementState:
    """random.sample(elems, randint(0, n)) on fixed slots."""
    k1, k2 = jax.random.split(key)
    n = st.count()
    c = jax.random.randint(k1, (), 0, n + 1)
    scores = jnp.where(st.valid, jax.random.uniform(k2, (st.num_slots,)), jnp.inf)
    rank = jnp.argsort(jnp.argsort(scores))
    return pack_state(st, (rank < c) & st.valid, st.num_slots)


def make_sample_fn(leaf: str, cfg: GenConfig):
    """Build the unbatched per-sample generation function for one leaf."""
    W, H = cfg.canvas_size
    E = cfg.max_elems
    L = seq_len_for(leaf)
    O = cfg.num_options
    init_fn, step_fn = RULES[leaf]
    n0 = proto_n_for(leaf)
    gs = cfg.grid_size

    def distractor_candidate(key, prev2: ElementState, prev1: ElementState,
                             use_grid, j: int) -> ElementState:
        if leaf in OVERLAY_LEAVES:
            k1, k2 = jax.random.split(key)
            return concat_states(_random_subset(k1, prev1),
                                 _random_subset(k2, prev2), E)
        if leaf == "翻转(镜像)" and j == 1:
            # reference: first distractor is the un-flipped previous frame
            # (src/generator.py:454-455)
            return prev1
        k1, k2 = jax.random.split(key)
        params = init_fn(k1, prev1, use_grid, W, H, gs)
        new, _ = step_fn(prev2, prev1, params, k2, jnp.asarray(1), use_grid,
                         W, H, gs)
        return new

    def one_sample(key, use_grid):
        kp, kc, kr, kd, ksh, kscan = jax.random.split(key, 6)

        init = sample_prototype(kp, W, H, E, n=n0, use_grid=use_grid,
                                grid_size=gs)
        init = _constrain_prototype(leaf, kc, init, W, H, gs)
        params = init_fn(kr, init, use_grid, W, H, gs)

        step_keys = jax.random.split(kscan, L - 1)

        def body(carry, xs):
            prev, cur, p = carry
            i, k = xs
            new, p = step_fn(prev, cur, p, k, i, use_grid, W, H, gs)
            return (cur, new, p), new

        (_, _, params_out), seq = jax.lax.scan(
            body, (init, init, params), (jnp.arange(1, L), step_keys))
        states = jax.tree.map(
            lambda a, b: jnp.concatenate([a[None], b], 0), init, seq)  # [L,...]

        frame = lambda t: jax.tree.map(lambda a: a[t], states)
        correct = frame(L - 1)
        prev1 = frame(L - 2)
        prev2 = frame(L - 3)

        # ---- distractors: K candidates per slot, first non-duplicate wins.
        # A final guaranteed-unique tier closes the all-K-collide hole the
        # reference plugs with a blank-image fallback (src/generator.py:
        # 444-509): O shifted copies of the last frame, pairwise-distinct by
        # construction, so with at most O-1 taken hashes pigeonhole always
        # leaves a free candidate (small candidate spaces like 翻转(镜像)'s
        # 3 flip modes can exhaust all K fresh draws).
        shift_amts = jnp.asarray(
            [(p * W) / (O + 1) for p in range(1, O + 1)], jnp.float32)

        def shifted_fallback(amt):
            st = prev1._replace(cx=(prev1.cx + amt) % W)
            return recompute_bbox_from_center(st, W, H)

        fallback = jax.vmap(shifted_fallback)(shift_amts)   # [O, ...]

        opt_states = [correct]
        hashes = [state_hash(correct)]
        dkeys = jax.random.split(kd, O - 1)
        for j in range(1, O):
            ckeys = jax.random.split(dkeys[j - 1], N_CANDIDATES)
            cands = jax.vmap(
                lambda k: distractor_candidate(k, prev2, prev1, use_grid, j)
            )(ckeys)
            cands = jax.tree.map(lambda a, b: jnp.concatenate([a, b], 0),
                                 cands, fallback)           # [K+O, ...]
            chashes = jax.vmap(state_hash)(cands)           # [K+O]
            taken = jnp.stack(hashes)                       # [J]
            ok = jnp.all(chashes[:, None] != taken[None, :], axis=1)
            pick = jnp.argmax(ok)  # fresh draws first; fallback tier last
            chosen = jax.tree.map(lambda a: a[pick], cands)
            opt_states.append(chosen)
            hashes.append(chashes[pick])

        options = jax.tree.map(lambda *xs: jnp.stack(xs), *opt_states)  # [O,...]

        # ---- shuffle options (reference src/generator.py:511-513)
        if cfg.shuffle_options:
            perm = jax.random.permutation(ksh, O)
        else:
            perm = jnp.arange(O)
        options = jax.tree.map(lambda a: a[perm], options)
        correct_index = jnp.argmax(perm == 0)

        # rendering happens at the batch level (see LeafPipeline.batch_fn):
        # frames are rasterized sequentially with batch-width parallelism so
        # peak HBM stays at O(batch) canvases instead of O(batch x frames)
        rframes = jax.tree.map(
            lambda s, o: jnp.concatenate([s, o], 0), states, options)
        return {
            "states": states, "options": options, "rframes": rframes,
            "perm": perm, "correct_index": correct_index,
            "use_grid": use_grid, "params": params_out,
        }

    return one_sample


class LeafPipeline:
    """Compiled batched generator for one rule leaf."""

    def __init__(self, leaf: str, cfg: GenConfig,
                 show_labels: bool = True, show_border: bool = True,
                 mesh=None):
        self.leaf = leaf
        self.cfg = cfg
        W, H = cfg.canvas_size
        self.L = seq_len_for(leaf)
        self.layout: GridLayout = build_layout(
            W, H, n_states=self.L - 1, num_options=cfg.num_options,
            show_labels=show_labels, show_border=show_border,
            bg_color=cfg.bg_color)
        sample_fn = make_sample_fn(leaf, cfg)
        layout = self.layout
        W, H = cfg.canvas_size
        L = self.L
        gs = cfg.grid_size

        # per-frame run capacities of the packed transfer streams; the
        # export path needs them to spot frames that overflowed (their
        # runs were scatter-dropped on device)
        from ...ops.rle import default_budget, default_grid_budget
        self.frame_budget = (getattr(cfg, "rle_budget", 0)
                             or default_budget(H, W))
        self.grid_budget = (getattr(cfg, "rle_budget_grid", 0)
                            or default_grid_budget(layout.grid_h, W))

        backend = getattr(cfg, "renderer", "auto")
        if backend == "auto":
            from ...utils.backend import auto_renderer
            backend = auto_renderer()
        if backend not in ("pallas", "jnp"):
            raise ValueError(f"unknown renderer {backend!r}")
        use_pallas = backend == "pallas"

        def batch_fn(keys, use_grid):
            out = jax.vmap(sample_fn)(keys, use_grid)
            rframes = out.pop("rframes")  # ElementState [B, F, E...]
            F = rframes.kind.shape[1]
            if use_pallas:
                # one kernel launch renders the whole [B*F] frame batch; it
                # pads any W/H up to its tile grid and crops
                from ...ops.raster_pallas import render_batch_pallas
                flat = jax.tree.map(
                    lambda a: a.reshape((-1,) + a.shape[2:]), rframes)
                ug_flat = jnp.repeat(use_grid, F)
                imgs = render_batch_pallas(flat, W, H, ug_flat, gs)
                imgs = imgs.reshape((-1, F) + imgs.shape[1:])
            else:
                # sequential over frames, parallel over batch: bounds the
                # [H, W, chunk] edge intermediates to one frame per sample
                frames_first = jax.tree.map(
                    lambda a: jnp.swapaxes(a, 0, 1), rframes)

                def render_one_frame(frame_b):
                    return jax.vmap(
                        lambda s, g: render_frame(s, W, H, use_grid=g,
                                                  grid_size=gs)
                    )(frame_b, use_grid)

                imgs = jax.lax.map(render_one_frame, frames_first)
                imgs = jnp.swapaxes(imgs, 0, 1)             # [B, F, ...]
            state_imgs = imgs[:, :L]
            option_imgs = imgs[:, L:]
            grids, grids_pre = jax.vmap(
                lambda s, o: compose_grid(layout, s[:L - 1], o,
                                          return_pre=True))(
                state_imgs, option_imgs)
            out["grid_img"] = grids
            # grid pHash for corpus dedup — on device, no image round-trip
            out["grid_phash"] = jax.vmap(phash)(grids)
            # grid_only: the per-frame images never leave the device —
            # ~9x fewer bytes over the host link when only the composed
            # puzzle is needed downstream
            if not getattr(cfg, "grid_only", False):
                out["state_imgs"] = state_imgs
                out["option_imgs"] = option_imgs
            # transfer codec: pack frames on device so exports move ~4x
            # ('sparse') to ~15x ('rle') fewer bytes over the host link;
            # raw frames stay device-resident for the overflow fallback
            if getattr(cfg, "sparse_transfer", True):
                codec = getattr(cfg, "transfer_codec", "rle4d")
                if codec in ("rle", "rle2", "rle3", "rle3d",
                             "rle4", "rle4d", "rle5", "rle5d"):
                    # rle3/rle3d pack per-frame rle2 here; the batch
                    # compaction + palettization (ops/rle.py::compact_rle3
                    # / compact_rle3d) runs in the generator OUTSIDE this
                    # jit so the pipeline's outputs keep their leading
                    # batch axis (mesh-sharded over 'data')
                    from ...ops.rle import (pack_batch_rle, pack_batch_rle2,
                                            default_budget,
                                            default_grid_budget)
                    budget = (getattr(cfg, "rle_budget", 0)
                              or default_budget(H, W))
                    gb = (getattr(cfg, "rle_budget_grid", 0)
                          or default_grid_budget(layout.grid_h, W))
                    pack = (pack_batch_rle if codec == "rle"
                            else pack_batch_rle2)
                else:
                    from ...ops.sparse import n_blocks
                    frac = getattr(cfg, "sparse_budget", 0.35)
                    gfrac = getattr(cfg, "sparse_budget_grid", 0.55)
                    budget = int(n_blocks(H, W) * frac)
                    gb = int(n_blocks(layout.grid_h, W) * gfrac)
                    pack = pack_batch
                if "state_imgs" in out:
                    if codec in ("rle3d", "rle4d", "rle5d"):
                        # inter-frame delta: rule steps change one or two
                        # element-sized regions, so state t encodes vs
                        # state t-1 (t=0 keys off the complement — no u8
                        # pixel equals 255-x) and every option encodes vs
                        # the last state it derives from.  Unchanged spans
                        # collapse to copy runs (ops/rle.py, v3d notes).
                        from ...ops.rle import pack_batch_rle2_delta
                        s_base = jnp.concatenate(
                            [255 - state_imgs[:, :1], state_imgs[:, :-1]],
                            axis=1)
                        out["state_imgs_packed"] = pack_batch_rle2_delta(
                            state_imgs, s_base, budget)
                        o_base = jnp.broadcast_to(
                            state_imgs[:, L - 1:L], option_imgs.shape)
                        out["option_imgs_packed"] = pack_batch_rle2_delta(
                            option_imgs, o_base, budget)
                    else:
                        out["state_imgs_packed"] = pack(state_imgs, budget)
                        out["option_imgs_packed"] = pack(option_imgs,
                                                         budget)
                # rle2 ships the PRE-overlay canvas (~37% fewer runs); the
                # host re-applies the static overlay with the exact same
                # integer blend (ops/compose.py::apply_overlay_u8).  The
                # full grid stays device-resident for pHash + the raw
                # overflow fallback.  The grid never delta-codes (each
                # sample's grid is unique), so rle3d grids ship as rle3.
                out["grid_img_packed"] = pack(
                    grids_pre if codec in ("rle2", "rle3", "rle3d",
                                           "rle4", "rle4d", "rle5", "rle5d")
                    else grids, gb)
            return out

        # the unjitted body, exposed for AOT export and for callers that
        # need to re-wrap it (e.g. the driver's single-chip entry) without
        # reaching into jax.jit internals
        self.batch_fn = batch_fn

        if mesh is not None:
            # data-parallel over the mesh: inputs and every output tensor
            # carry a leading batch axis sharded over 'data'; XLA partitions
            # the whole program with no cross-chip communication (the dedup
            # all_gather lives in parallel/mesh.py, outside this jit)
            from jax.sharding import NamedSharding, PartitionSpec as P
            shard = NamedSharding(mesh, P("data"))
            self._batch_fn = jax.jit(batch_fn, in_shardings=(shard, shard),
                                     out_shardings=shard)
        else:
            self._batch_fn = jax.jit(batch_fn)
        self.mesh = mesh
        # AOT executable cache (utils/aot.py): per batch size, the compiled
        # executable loads from disk without tracing/lowering/compiling.
        self._aot_enabled = bool(getattr(cfg, "aot", True))
        self._aot: dict = {}  # B -> jax.stages.Compiled | None

    def _aot_tag(self, B: int) -> str:
        """Cache tag capturing everything the traced program depends on
        (the package-source + env fingerprints live in utils/aot.py)."""
        import dataclasses
        import hashlib
        import numpy as np
        d = dataclasses.asdict(self.cfg)
        d.pop("out_dir", None)
        d.pop("seed", None)  # keys are inputs; seed never enters the trace
        # getattr-style extension knobs are not dataclass fields
        for k in ("grid_only", "rle_budget", "rle_budget_grid",
                  "sparse_budget", "sparse_budget_grid"):
            d[k] = getattr(self.cfg, k, None)
        d["_layout"] = (self.layout.grid_h,
                        self.frame_budget, self.grid_budget)
        # the overlay/query-patch pixels are baked into the traced program
        # as CONSTANTS; generator ctor args (show_labels/show_border) alter
        # them without touching any GenConfig field or grid_h, so the tag
        # must hash the actual content or a --no_labels run would load a
        # stale labeled executable
        lay_h = hashlib.sha256()
        for arr in (self.layout.overlay_rgb_u8, self.layout.overlay_a8,
                    self.layout.query_patch):
            if arr is not None:
                lay_h.update(np.ascontiguousarray(arr).tobytes())
        d["_layout_content"] = lay_h.hexdigest()[:12]
        d["_mesh"] = (tuple(self.mesh.shape.items())
                      if self.mesh is not None else None)
        cfg_h = hashlib.sha256(
            repr(sorted(d.items())).encode()).hexdigest()[:12]
        return f"rpm-{self.leaf}-B{B}-{cfg_h}"

    def _compiled_for(self, keys, use_grid):
        B = int(keys.shape[0])
        if B not in self._aot:
            from ...utils.aot import load_or_compile
            avals = (jax.ShapeDtypeStruct(keys.shape, keys.dtype),
                     jax.ShapeDtypeStruct((B,), jnp.bool_))
            # the AOT round-trip is only safe when the program was
            # compiled across EVERY visible device: deserialize_and_load
            # spans all of them, so an executable built on a subset mesh
            # (small batch on a big host) comes back expecting the wrong
            # shard count (load_or_compile docstring)
            spans = (self.mesh is not None
                     and self.mesh.size == jax.device_count())
            self._aot[B] = load_or_compile(
                self._aot_tag(B), self._batch_fn, avals,
                enabled=self._aot_enabled, spans_all_devices=spans)
        return self._aot[B]

    def __call__(self, keys, use_grid):
        compiled = self._compiled_for(keys, use_grid)
        if compiled is not None:
            return compiled(keys, jnp.asarray(use_grid, jnp.bool_))
        return self._batch_fn(keys, use_grid)


from functools import partial


@partial(jax.jit, static_argnums=0)
def sample_keys(seed: int, sample_ids) -> jnp.ndarray:
    """Per-sample keys: fold_in(master, id) replicates the reference's
    seed+index discipline (src/cli.py:20-21) in jax.random land.

    Jitted (seed static — one value per run): the unjitted version
    re-traced the vmap on every batch, ~250 ms of host time per dispatch
    that serialized against the single-core export pool."""
    master = jax.random.key(seed)
    return jax.vmap(lambda i: jax.random.fold_in(master, i))(
        jnp.asarray(sample_ids))
