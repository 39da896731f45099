# rules.py — sequence-transformation rule engine on ElementState tensors.
"""Pure-functional rule engine.

Each reference rule handler (reference src/rules.py RULE_MAP, :1642-1672) is
rebuilt as a pair:

- ``init_<rule>(key, init_state, use_grid, cfg)`` samples the rule's
  parameters once from the *initial* frame (the reference samples lazily on
  first application and then threads them through ``rule_info``;
  front-loading is equivalent because the parameters depend only on frame 0);
- ``step_<rule>(prev, cur, params, key, i, use_grid, cfg)`` applies one
  sequence step: ``(history[-2], history[-1]) -> history[-1] + 1``.

Steps are driven by ``lax.scan`` in pipeline.py; each leaf gets its own
statically-specialized program (no lax.switch: under vmap a switch computes
every branch for every sample, so per-leaf XLA programs are both simpler and
faster).

Deliberate divergences from the reference, documented per SURVEY.md §7.3:
- 旋转 with a circle element and 翻转(镜像) with the element in the canvas'
  center cell make the reference spin forever and die by watchdog timeout
  (reference src/rules.py:223-229, 360-364).  We instead constrain the
  prototype sampler so those samples are *valid* (see pipeline.py), trading
  bug-for-bug parity for throughput.
- RNG streams are jax.random; distributions match, draws do not.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.config import KIND_ID
from ...utils.state import ElementState
from .sampler import sample_prototype

CIRCLE = KIND_ID["circle"]
MAXSEQ = 8
MAX_ANGLE_CHOICES = 8

# per-kind allowed rotation deltas (reference src/rules.py:232-239 / 730-743);
# kinds absent from the table use the default 45-degree ladder.
_DEFAULT_ANGLES = [0, 45, 90, 135, 180, 225, 270, 315]
_ANGLES_BY_KIND = {
    "triangle": [30, 45, 60, 90],
    "square": [30, 45, 60],
    "rounded_square": [30, 45, 60],
    "diamond": [30, 45, 60, 90],
    "star": [30, 45, 60, 90],
}


def _angle_table():
    from ...utils.config import SHAPE_KINDS
    tab = np.zeros((len(SHAPE_KINDS), MAX_ANGLE_CHOICES), np.float32)
    cnt = np.zeros((len(SHAPE_KINDS),), np.int32)
    for i, k in enumerate(SHAPE_KINDS):
        allowed = _ANGLES_BY_KIND.get(k, _DEFAULT_ANGLES)
        if k == "circle":
            allowed = [0]  # never selected: rotate excludes circles
        tab[i, :len(allowed)] = allowed
        tab[i, len(allowed):] = allowed[0]
        cnt[i] = len(allowed)
    # numpy, not jnp: module-level device arrays would initialize the
    # backend (and claim the device) at import time; traced use sites
    # lift them with jnp.asarray
    return tab, cnt


ANGLE_TAB, ANGLE_CNT = _angle_table()

# transform_many's per-step rotate snap map (reference src/rules.py:734-742):
# identical table but WITH the default row used for unlisted kinds, and
# circle's empty set meaning "keep the originally sampled delta".
TM_ANGLE_TAB, TM_ANGLE_CNT = ANGLE_TAB, ANGLE_CNT


def _choice(key, table_row, count):
    """Uniform choice among the first `count` entries of a padded row."""
    i = jax.random.randint(key, (), 0, jnp.maximum(count, 1))
    return table_row[i]


def _rand_pick_valid(key, valid):
    """Uniform index among valid slots (like random.randint over n live)."""
    n = jnp.maximum(1, jnp.sum(valid.astype(jnp.int32)))
    r = jax.random.randint(key, (), 0, n)
    # index of the r-th valid slot
    cum = jnp.cumsum(valid.astype(jnp.int32)) - 1
    return jnp.argmax((cum == r) & valid)


def _clip_bbox(bx, by, bw, bh, W, H):
    """Shift-then-shrink clipping used by every reference rule
    (e.g. src/rules.py:127-146)."""
    bx = jnp.maximum(bx, 0.0)
    by = jnp.maximum(by, 0.0)
    shift_x = jnp.maximum(0.0, bx + bw - W)
    shift_y = jnp.maximum(0.0, by + bh - H)
    bx = jnp.maximum(0.0, bx - shift_x)
    by = jnp.maximum(0.0, by - shift_y)
    bw = jnp.where(bx + bw > W, jnp.maximum(1.0, W - bx), bw)
    bh = jnp.where(by + bh > H, jnp.maximum(1.0, H - by), bh)
    return bx, by, bw, bh


def _set_elem(state: ElementState, idx, **fields) -> ElementState:
    """Functional update of a single (traced) element slot."""
    upd = {}
    for name, val in fields.items():
        arr = getattr(state, name)
        upd[name] = arr.at[idx].set(val)
    return state._replace(**upd)


def pack_state(state: ElementState, keep: jnp.ndarray, max_out: int) -> ElementState:
    """Compact kept elements to the front slots (stable), mask the rest."""
    keep = keep & state.valid
    order = jnp.argsort(~keep, stable=True)  # kept slots first, stable
    gathered = jax.tree.map(lambda a: a[order], state)
    n_keep = jnp.sum(keep.astype(jnp.int32))
    slot = jnp.arange(state.num_slots)
    new_valid = slot < jnp.minimum(n_keep, max_out)
    return gathered._replace(valid=new_valid)


def concat_states(a: ElementState, b: ElementState, max_out: int) -> ElementState:
    """history[-1] + history[-2]-style concat, packed into max_out slots."""
    joined = jax.tree.map(lambda x, y: jnp.concatenate([x, y], 0), a, b)
    packed = pack_state(joined, joined.valid, 2 * a.num_slots)
    return jax.tree.map(lambda x: x[:max_out], packed)


# ===========================================================================
# 平移 rule_translate (reference src/rules.py:22-202)
# ===========================================================================

class TranslateParams(NamedTuple):
    idx: jnp.ndarray
    is_horizontal: jnp.ndarray
    dist: jnp.ndarray  # grid steps if use_grid else pixels


def init_translate(key, init_state, use_grid, W, H, grid_size=3):
    k1, k2, k3 = jax.random.split(key, 3)
    idx = _rand_pick_valid(k1, init_state.valid)
    is_h = jax.random.bernoulli(k2)
    steps = jnp.asarray([-2, -1, 1, 2])
    step = steps[jax.random.randint(k3, (), 0, 4)]
    dist = jnp.where(use_grid, step, step * (min(W, H) // 3))
    return TranslateParams(idx, is_h, dist)


def step_translate(prev, cur, p: TranslateParams, key, i, use_grid, W, H,
                   grid_size=3):
    st = cur
    e = p.idx
    cx, cy = st.cx[e], st.cy[e]
    bw, bh = jnp.maximum(1.0, st.bbox[e, 2]), jnp.maximum(1.0, st.bbox[e, 3])

    # grid branch: move whole cells, land exactly on the cell center
    # (the reference drops the jitter offset, src/rules.py:115-120)
    cell_w, cell_h = W / grid_size, H / grid_size
    col = jnp.clip(jnp.floor(cx / cell_w), 0, grid_size - 1)
    row = jnp.clip(jnp.floor(cy / cell_h), 0, grid_size - 1)
    new_col = jnp.mod(col + jnp.where(p.is_horizontal, p.dist, 0), grid_size)
    new_row = jnp.mod(row + jnp.where(p.is_horizontal, 0, p.dist), grid_size)
    g_cx = jnp.clip(jnp.round((new_col + 0.5) * cell_w), 0, W)
    g_cy = jnp.clip(jnp.round((new_row + 0.5) * cell_h), 0, H)

    # pixel branch: unclamped center shift (wrap-around shows it visually)
    px_cx = cx + jnp.where(p.is_horizontal, p.dist, 0)
    px_cy = cy + jnp.where(p.is_horizontal, 0, p.dist)

    new_cx = jnp.where(use_grid, g_cx, px_cx)
    new_cy = jnp.where(use_grid, g_cy, px_cy)
    nbx, nby, nbw, nbh = _clip_bbox(jnp.round(new_cx - bw / 2),
                                    jnp.round(new_cy - bh / 2), bw, bh, W, H)
    st = _set_elem(st, e, cx=new_cx, cy=new_cy,
                   bbox=jnp.stack([nbx, nby, nbw, nbh]))
    return st, p


# ===========================================================================
# 旋转 rule_rotate (reference src/rules.py:204-334)
# ===========================================================================

class RotateParams(NamedTuple):
    idx: jnp.ndarray
    delta: jnp.ndarray  # requested per-step angle increment


def init_rotate(key, init_state, use_grid, W, H, grid_size=3):
    k1, k2 = jax.random.split(key)
    # pick a non-circle element (the pipeline guarantees one exists; the
    # reference instead loops forever when there is none)
    ok = init_state.valid & (init_state.kind != CIRCLE)
    idx = _rand_pick_valid(k1, ok)
    kind = init_state.kind[idx]
    delta = _choice(k2, jnp.asarray(ANGLE_TAB)[kind],
                    jnp.asarray(ANGLE_CNT)[kind])
    return RotateParams(idx, delta)


def step_rotate(prev, cur, p: RotateParams, key, i, use_grid, W, H,
                grid_size=3):
    st = cur
    e = p.idx
    cur_angle = jnp.mod(st.angle[e], 360.0)
    applied = jnp.mod(cur_angle + p.delta, 360.0)
    raw = jnp.mod(applied - cur_angle, 360.0)
    delta = jnp.where(raw >= 180.0, raw - 360.0, raw)

    bw = jnp.maximum(1.0, st.bbox[e, 2])
    bh = jnp.maximum(1.0, st.bbox[e, 3])
    th = jnp.deg2rad(delta)
    c, s = jnp.abs(jnp.cos(th)), jnp.abs(jnp.sin(th))
    nbw = jnp.maximum(1.0, jnp.round(bw * c + bh * s))
    nbh = jnp.maximum(1.0, jnp.round(bw * s + bh * c))
    nbx, nby, nbw, nbh = _clip_bbox(jnp.round(st.cx[e] - nbw / 2),
                                    jnp.round(st.cy[e] - nbh / 2), nbw, nbh, W, H)
    st = _set_elem(st, e, angle=applied,
                   bbox=jnp.stack([nbx, nby, nbw, nbh]))
    return st, p


# ===========================================================================
# 翻转(镜像) rule_flip (reference src/rules.py:337-442)
# ===========================================================================

class FlipParams(NamedTuple):
    idx: jnp.ndarray
    mode: jnp.ndarray  # 0=h, 1=v, 2=both


def init_flip(key, init_state, use_grid, W, H, grid_size=3):
    k1, k2 = jax.random.split(key)
    # element must not sit in the canvas' center cell (the pipeline's
    # prototype constraint guarantees this; the reference loops forever)
    cell_w, cell_h = W / grid_size, H / grid_size
    centered = ((jnp.floor(init_state.cx / cell_w) == grid_size // 2) &
                (jnp.floor(init_state.cy / cell_h) == grid_size // 2))
    ok = init_state.valid & ~centered
    ok = jnp.where(jnp.any(ok), ok, init_state.valid)  # degrade gracefully
    idx = _rand_pick_valid(k1, ok)
    mode = jax.random.randint(k2, (), 0, 3)
    return FlipParams(idx, mode)


def _flip_once(st: ElementState, e, mode, W, H):
    do_h = (mode == 0) | (mode == 2)
    do_v = (mode == 1) | (mode == 2)
    cx, cy = st.cx[e], st.cy[e]
    bx, by = st.bbox[e, 0], st.bbox[e, 1]
    bw = jnp.maximum(1.0, st.bbox[e, 2])
    bh = jnp.maximum(1.0, st.bbox[e, 3])
    new_cx = jnp.where(do_h, jnp.round(W - cx), cx)
    new_cy = jnp.where(do_v, jnp.round(H - cy), cy)
    nbx = jnp.where(do_h, jnp.round(W - (bx + bw)), bx)
    nby = jnp.where(do_v, jnp.round(H - (by + bh)), by)
    nbx, nby, bw, bh = _clip_bbox(nbx, nby, bw, bh, W, H)
    return _set_elem(st, e, cx=new_cx, cy=new_cy,
                     bbox=jnp.stack([nbx, nby, bw, bh]),
                     flip_h=jnp.where(do_h, ~st.flip_h[e], st.flip_h[e]),
                     flip_v=jnp.where(do_v, ~st.flip_v[e], st.flip_v[e]))


def step_flip(prev, cur, p: FlipParams, key, i, use_grid, W, H, grid_size=3):
    return _flip_once(cur, p.idx, p.mode, W, H), p


# ===========================================================================
# 组合 rule_transform_many (reference src/rules.py:444-707)
# ===========================================================================

class TransformManyParams(NamedTuple):
    active: jnp.ndarray     # bool [E]
    op: jnp.ndarray         # i32 [E]: 0=translate, 1=rotate, 2=flip
    dx: jnp.ndarray         # f32 []  shared translate param
    dy: jnp.ndarray         # f32 []
    grid_dist: jnp.ndarray  # i32 []  grid-mode steps
    grid_is_h: jnp.ndarray  # bool []
    flip_mode: jnp.ndarray  # i32 []
    rot_delta: jnp.ndarray  # f32 []  initial sample (re-snapped per step)


def init_transform_many(key, init_state, use_grid, W, H, grid_size=3):
    ks = jax.random.split(key, 10)
    n = jnp.maximum(1, init_state.count())
    max_select = jnp.minimum(3, n)
    count = jax.random.randint(ks[0], (), 1, max_select + 1)
    # random.sample(range(n), count): random scores, keep `count` smallest
    scores = jnp.where(init_state.valid,
                       jax.random.uniform(ks[1], (init_state.num_slots,)), jnp.inf)
    rank = jnp.argsort(jnp.argsort(scores))
    active = (rank < count) & init_state.valid
    op = jax.random.randint(ks[2], (init_state.num_slots,), 0, 3)

    # pixel translate: off in [min//10, min//6]; dx = ±off or 0; dy=-off iff dx==0
    mn = min(W, H)
    off = jax.random.randint(ks[3], (), mn // 10, mn // 6 + 1).astype(jnp.float32)
    r = jax.random.uniform(ks[4])
    sgn = jnp.where(jax.random.bernoulli(ks[5]), 1.0, -1.0)
    dx = jnp.where(r < 0.5, sgn * off, 0.0)
    dy = jnp.where(dx == 0, -off, 0.0)

    steps = jnp.asarray([-2, -1, 1, 2])
    grid_dist = steps[jax.random.randint(ks[6], (), 0, 4)]
    grid_is_h = jax.random.bernoulli(ks[7])
    flip_mode = jax.random.randint(ks[8], (), 0, 3)
    rot_delta = jnp.asarray([45., 90., 135., 180., 225., 270., 315.])[
        jax.random.randint(ks[9], (), 0, 7)]
    return TransformManyParams(active, op, dx, dy, grid_dist, grid_is_h,
                               flip_mode, rot_delta)


def step_transform_many(prev, cur, p: TransformManyParams, key, i, use_grid,
                        W, H, grid_size=3):
    st = cur
    E = st.num_slots
    keys = jax.random.split(key, E)
    cell_w, cell_h = W / grid_size, H / grid_size

    def apply_slot(st, e):
        is_t = p.active[e] & (p.op[e] == 0)
        is_r = p.active[e] & (p.op[e] == 1)
        is_f = p.active[e] & (p.op[e] == 2)
        cx, cy = st.cx[e], st.cy[e]
        bx, by = st.bbox[e, 0], st.bbox[e, 1]
        bw = jnp.maximum(1.0, st.bbox[e, 2])
        bh = jnp.maximum(1.0, st.bbox[e, 3])

        # --- translate (canvas-modular in pixel mode, src/rules.py:630-631)
        g_dx = jnp.where(p.grid_is_h, p.grid_dist, 0)
        g_dy = jnp.where(p.grid_is_h, 0, p.grid_dist)
        col = jnp.clip(jnp.floor(cx / cell_w), 0, grid_size - 1)
        row = jnp.clip(jnp.floor(cy / cell_h), 0, grid_size - 1)
        ncol = jnp.mod(col + g_dx, grid_size)
        nrow = jnp.mod(row + g_dy, grid_size)
        off_x = jnp.clip(cx - (col + 0.5) * cell_w,
                         -jnp.maximum(0.0, (cell_w - bw) / 2),
                         jnp.maximum(0.0, (cell_w - bw) / 2))
        off_y = jnp.clip(cy - (row + 0.5) * cell_h,
                         -jnp.maximum(0.0, (cell_h - bh) / 2),
                         jnp.maximum(0.0, (cell_h - bh) / 2))
        t_cx = jnp.where(use_grid,
                         jnp.round((ncol + 0.5) * cell_w + off_x),
                         jnp.mod(jnp.round(cx + p.dx), W))
        t_cy = jnp.where(use_grid,
                         jnp.round((nrow + 0.5) * cell_h + off_y),
                         jnp.mod(jnp.round(cy + p.dy), H))

        # --- rotate: per-step re-snap to the kind's allowed set
        # (the reference re-randomizes the delta every application,
        # src/rules.py:645-652)
        kind = st.kind[e]
        snapped = _choice(keys[e], jnp.asarray(TM_ANGLE_TAB)[kind],
                           jnp.asarray(TM_ANGLE_CNT)[kind])
        delta = jnp.where(kind == CIRCLE, p.rot_delta, snapped)
        new_angle = jnp.mod(st.angle[e] + delta, 360.0)
        th = jnp.deg2rad(delta)
        c, s = jnp.abs(jnp.cos(th)), jnp.abs(jnp.sin(th))
        r_bw = jnp.maximum(1.0, jnp.round(bw * c + bh * s))
        r_bh = jnp.maximum(1.0, jnp.round(bw * s + bh * c))

        # --- flip
        do_h = (p.flip_mode == 0) | (p.flip_mode == 2)
        do_v = (p.flip_mode == 1) | (p.flip_mode == 2)
        f_cx = jnp.where(do_h, jnp.round(W - cx), cx)
        f_cy = jnp.where(do_v, jnp.round(H - cy), cy)

        # select by op
        new_cx = jnp.where(is_t, t_cx, jnp.where(is_f, f_cx, cx))
        new_cy = jnp.where(is_t, t_cy, jnp.where(is_f, f_cy, cy))
        out_angle = jnp.where(is_r, new_angle, st.angle[e])
        out_bw = jnp.where(is_r, r_bw, bw)
        out_bh = jnp.where(is_r, r_bh, bh)
        nbx, nby, out_bw, out_bh = _clip_bbox(jnp.round(new_cx - out_bw / 2),
                                              jnp.round(new_cy - out_bh / 2),
                                              out_bw, out_bh, W, H)
        st = _set_elem(st, e, cx=new_cx, cy=new_cy, angle=out_angle,
                       bbox=jnp.stack([nbx, nby, out_bw, out_bh]),
                       flip_h=jnp.where(is_f & do_h, ~st.flip_h[e], st.flip_h[e]),
                       flip_v=jnp.where(is_f & do_v, ~st.flip_v[e], st.flip_v[e]))
        return st

    for e in range(E):
        st = apply_slot(st, e)
    return st, p


# ===========================================================================
# overlay triplet 直接叠加 / 去同存异 / 去异存同
# (reference src/rules.py:1084-1191 / 1193-1442 / 1445-1639)
# ===========================================================================

class OverlayParams(NamedTuple):
    dummy: jnp.ndarray  # key-driven rules carry no persistent params


def init_overlay(key, init_state, use_grid, W, H, grid_size=3):
    return OverlayParams(jnp.zeros(()))


def _pairwise_same(a: ElementState, b: ElementState,
                   iou_thresh=0.5, size_rel=0.2, angle_deg=5.0):
    """same-element test matrix [Ea, Eb]
    (reference src/rules.py:1364-1433: kind ∧ IoU ∧ size ∧ angle)."""
    ax0, ay0 = a.bbox[:, 0, None], a.bbox[:, 1, None]
    aw, ah = a.bbox[:, 2, None], a.bbox[:, 3, None]
    bx0, by0 = b.bbox[None, :, 0], b.bbox[None, :, 1]
    bw, bh = b.bbox[None, :, 2], b.bbox[None, :, 3]
    x1 = jnp.maximum(ax0, bx0)
    y1 = jnp.maximum(ay0, by0)
    x2 = jnp.minimum(ax0 + aw, bx0 + bw)
    y2 = jnp.minimum(ay0 + ah, by0 + bh)
    inter = jnp.maximum(0.0, x2 - x1) * jnp.maximum(0.0, y2 - y1)
    union = aw * ah + bw * bh - inter
    iou = jnp.where(union > 0, inter / union, 0.0)

    smax = jnp.maximum(a.size[:, None], b.size[None, :])
    srel = jnp.where(smax > 0,
                     jnp.abs(a.size[:, None] - b.size[None, :]) / smax, 0.0)
    adiff = jnp.abs(jnp.mod(a.angle[:, None] - b.angle[None, :] + 180.0,
                            360.0) - 180.0)
    same = ((a.kind[:, None] == b.kind[None, :]) &
            (iou >= iou_thresh) & (srel <= size_rel) & (adiff <= angle_deg))
    return same & a.valid[:, None] & b.valid[None, :]


def _replace_some(cur: ElementState, key, use_grid, W, H, grid_size):
    """frame_count % 3 != 2 branch of 去同存异/去异存同: replace r∈[1,n-1]
    random elements with freshly sampled prototype elements
    (reference src/rules.py:1301-1350)."""
    k1, k2, k3 = jax.random.split(key, 3)
    E = cur.num_slots
    n = cur.count()
    proto = sample_prototype(k3, W, H, E, n=None, use_grid=use_grid,
                             grid_size=grid_size)
    # n <= 1: append one fresh element instead
    append_case = n <= 1
    first_free = jnp.argmin(cur.valid)  # first invalid slot

    r = jax.random.randint(k1, (), 1, jnp.maximum(2, n))
    scores = jnp.where(cur.valid, jax.random.uniform(k2, (E,)), jnp.inf)
    rank = jnp.argsort(jnp.argsort(scores))
    replaced = (rank < r) & cur.valid & ~append_case

    # map each replaced slot to a distinct proto element (in order)
    proto_idx = jnp.clip(jnp.cumsum(replaced.astype(jnp.int32)) - 1, 0, E - 1)

    def mix(cur_f, proto_f):
        take = replaced
        pf = proto_f[proto_idx]
        return jnp.where(take.reshape(take.shape + (1,) * (cur_f.ndim - 1)),
                         pf, cur_f)

    mixed = jax.tree.map(mix, cur, proto)
    mixed = mixed._replace(valid=cur.valid)

    # append branch: put proto element 0 into the first free slot
    def put(mix_f, proto_f):
        return jnp.where(
            append_case & (jnp.arange(E) == first_free).reshape(
                (E,) + (1,) * (mix_f.ndim - 1)),
            proto_f[0], mix_f)

    out = jax.tree.map(put, mixed, proto)
    out = out._replace(valid=jnp.where(append_case,
                                       cur.valid | (jnp.arange(E) == first_free),
                                       cur.valid))
    return out


def step_direct_overlay(prev, cur, p, key, i, use_grid, W, H, grid_size=3):
    """直接叠加: fresh prototype except every 3rd frame merges the last two
    (reference src/rules.py:1167-1191)."""
    frame_count = i  # history length before this step
    fresh = sample_prototype(key, W, H, cur.num_slots, n=None,
                             use_grid=use_grid, grid_size=grid_size)
    merged = concat_states(cur, prev, cur.num_slots)
    is_merge = (frame_count % 3) == 2
    out = jax.tree.map(lambda a, b: jnp.where(
        jnp.reshape(is_merge, (1,) * a.ndim), a, b), merged, fresh)
    return out, p


def step_diff_keep_same(prev, cur, p, key, i, use_grid, W, H, grid_size=3):
    """去同存异: symmetric difference of the last two frames on merge steps
    (reference src/rules.py:1352-1442)."""
    frame_count = i
    replaced = _replace_some(cur, key, use_grid, W, H, grid_size)

    same = _pairwise_same(cur, prev)
    cur_keep = cur.valid & ~jnp.any(same, axis=1)
    prev_keep = prev.valid & ~jnp.any(same, axis=0)
    sym = concat_states(pack_state(cur, cur_keep, cur.num_slots),
                        pack_state(prev, prev_keep, prev.num_slots),
                        cur.num_slots)

    is_merge = (frame_count % 3) == 2
    out = jax.tree.map(lambda a, b: jnp.where(
        jnp.reshape(is_merge, (1,) * a.ndim), a, b), sym, replaced)
    return out, p


def step_diff_keep_intersection(prev, cur, p, key, i, use_grid, W, H,
                                grid_size=3):
    """去异存同: keep last-frame elements matched in prev; force-keep the
    largest if the intersection is empty (reference src/rules.py:1587-1639)."""
    frame_count = i
    replaced = _replace_some(cur, key, use_grid, W, H, grid_size)

    same = _pairwise_same(cur, prev)
    keep = cur.valid & jnp.any(same, axis=1)
    area = jnp.where(cur.valid, cur.bbox[:, 2] * cur.bbox[:, 3], -1.0)
    biggest = jnp.argmax(area)
    keep = jnp.where(jnp.any(keep), keep,
                     cur.valid & (jnp.arange(cur.num_slots) == biggest))
    inter = pack_state(cur, keep, cur.num_slots)

    is_merge = (frame_count % 3) == 2
    out = jax.tree.map(lambda a, b: jnp.where(
        jnp.reshape(is_merge, (1,) * a.ndim), a, b), inter, replaced)
    return out, p


# ===========================================================================
# 单一遍历 rule_traverse_sequence (reference src/rules.py:751-883)
# ===========================================================================

class TraverseSeqParams(NamedTuple):
    seq: jnp.ndarray      # i32 [MAXSEQ] kind ids
    seq_len: jnp.ndarray  # i32 []


# numpy at module scope (a jnp constant would device_put at import and
# start the backend); lifted to device at trace time
_TRAVERSE_KINDS = np.asarray([KIND_ID[k] for k in
                              ("square", "circle", "triangle", "diamond", "star")])


def init_traverse_sequence(key, init_state, use_grid, W, H, grid_size=3,
                           seq_len: int = 3):
    fill = jnp.asarray(_TRAVERSE_KINDS)[jax.random.randint(key, (MAXSEQ,), 0, 5)]
    seq = fill.at[0].set(init_state.kind[0]).at[1].set(init_state.kind[1])
    return TraverseSeqParams(seq, jnp.asarray(seq_len))


def step_traverse_sequence(prev, cur, p: TraverseSeqParams, key, i, use_grid,
                           W, H, grid_size=3):
    # closed form of the reference's stepping: frame i has
    # elem0.kind = seq[i % len], elem1.kind = seq[(i+1) % len]
    k0 = p.seq[jnp.mod(i, p.seq_len)]
    k1 = p.seq[jnp.mod(i + 1, p.seq_len)]
    st = cur.at_set("kind", 0, k0)
    st = st.at_set("kind", 1, k1)
    # circles render with angle 0 regardless; keep angles as-is (reference
    # keeps all other attributes unchanged)
    return st, p


# ===========================================================================
# 位置遍历 rule_traverse_positions (reference src/rules.py:886-1018)
# ===========================================================================

class TraversePosParams(NamedTuple):
    pos: jnp.ndarray      # f32 [MAXSEQ, 2]
    pos_len: jnp.ndarray  # i32 []
    size_hint: jnp.ndarray


def init_traverse_positions(key, init_state, use_grid, W, H, grid_size=3,
                            seq_len: int = 3, size_hint: float = 80.0):
    lo = size_hint / 2
    rand = jax.random.uniform(key, (MAXSEQ, 2),
                              minval=lo, maxval=jnp.asarray([W - lo, H - lo]))
    pos = rand.at[0].set(jnp.stack([init_state.cx[0], init_state.cy[0]]))
    pos = pos.at[1].set(jnp.stack([init_state.cx[1], init_state.cy[1]]))
    return TraversePosParams(pos, jnp.asarray(seq_len), jnp.asarray(size_hint))


def step_traverse_positions(prev, cur, p: TraversePosParams, key, i, use_grid,
                            W, H, grid_size=3):
    p1 = p.pos[jnp.mod(i, p.pos_len)]
    p2 = p.pos[jnp.mod(i + 1, p.pos_len)]
    s = p.size_hint
    st = cur
    for e, pe in ((0, p1), (1, p2)):
        # reference quirk: bbox stored as (x0, y0, x1, y1) here, with the
        # 80px size_hint rather than the element's size (src/rules.py:999)
        st = _set_elem(st, e, cx=pe[0], cy=pe[1],
                       bbox=jnp.stack([pe[0] - s / 2, pe[1] - s / 2,
                                       pe[0] + s / 2, pe[1] + s / 2]))
    return st, p


# ===========================================================================
# 元素传递 rule_element_transfer (reference src/rules.py:1020-1045)
# ===========================================================================
# The reference version is dead code: it calls undefined helpers
# (get_canvas_and_elements / paste) and would NameError if ever invoked
# (it is registered in RULE_MAP but absent from DEFAULT_CATEGORIES, so it
# never samples).  This is a working realization of its documented intent:
# copy the largest element of the previous frame into the center of the
# current frame.


def init_element_transfer(key, init_state, use_grid, W, H, grid_size=3):
    return OverlayParams(jnp.zeros(()))


def step_element_transfer(prev, cur, p, key, i, use_grid, W, H, grid_size=3):
    area = jnp.where(prev.valid, prev.size, -1.0)
    big = jnp.argmax(area)
    first_free = jnp.argmin(cur.valid)
    has_room = ~jnp.all(cur.valid)
    E = cur.num_slots

    def put(cur_f, prev_f):
        sel = (jnp.arange(E) == first_free) & has_room
        src = prev_f[big]
        return jnp.where(sel.reshape((E,) + (1,) * (cur_f.ndim - 1)),
                         src, cur_f)

    out = jax.tree.map(put, cur, prev)
    # transferred element lands at the canvas center
    out = out._replace(
        cx=jnp.where(jnp.arange(E) == first_free,
                     jnp.where(has_room, W / 2.0, out.cx), out.cx),
        cy=jnp.where(jnp.arange(E) == first_free,
                     jnp.where(has_room, H / 2.0, out.cy), out.cy),
        valid=cur.valid | ((jnp.arange(E) == first_free) & has_room))
    return out, p


# ===========================================================================
# registry
# ===========================================================================

RULES = {
    "平移": (init_translate, step_translate),
    "旋转": (init_rotate, step_rotate),
    "翻转(镜像)": (init_flip, step_flip),
    "组合": (init_transform_many, step_transform_many),
    "直接叠加": (init_overlay, step_direct_overlay),
    "去同存异": (init_overlay, step_diff_keep_same),
    "去异存同": (init_overlay, step_diff_keep_intersection),
    "单一遍历": (init_traverse_sequence, step_traverse_sequence),
    "位置遍历": (init_traverse_positions, step_traverse_positions),
    # reference alias: '多遍历' → rule_translate (src/rules.py:1657)
    "多遍历": (init_translate, step_translate),
    # registered-but-dead in the reference (src/rules.py:1659); working here
    "元素传递": (init_element_transfer, step_element_transfer),
}
