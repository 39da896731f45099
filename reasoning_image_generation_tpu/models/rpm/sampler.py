# sampler.py — prototype scene sampler (jax.random port of populate_prototype).
"""Samples an initial ElementState frame.

Reproduces the distributions of the reference's ``populate_prototype``
(reference src/sample.py:9-226):

- n ∈ {1,2,3} elements (uniform) unless pinned by the rule;
- grid mode: distinct shuffled cells, fixed size 0.6·cell_short,
  jitter ±0.2·cell_short (src/sample.py:61-75,163-173);
- non-grid 'random' arrangement: size = min(W,H)//4 ± base//3, uniform
  position with a 5px + size/2 margin, extra jitter min(size//4,10)
  (src/sample.py:78-147,174-183);
- kind uniform over the 11 kinds, fill 2/3 true, stroke ∈ {1,2,3},
  angle ∈ {0,45,90,135,180} (0 for circles), BGR color ∈ [30,220]
  (src/sample.py:149-221).

Randomness is `jax.random` key-folded, not global seeding: the RNG-stream
contract is identical *distributions*, not identical draws (SURVEY.md §7.3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.config import KIND_ID, SHAPE_KINDS
from ...utils.state import ElementState, empty_state, recompute_bbox_from_center

NKINDS = len(SHAPE_KINDS)
CIRCLE = KIND_ID["circle"]
# numpy at module scope (a jnp constant would device_put at import and
# start the backend); lifted to device at trace time
ANGLE_CHOICES = np.asarray([0.0, 45.0, 90.0, 135.0, 180.0], np.float32)


def sample_prototype(key, W: int, H: int, max_elems: int,
                     n=None, use_grid=False, grid_size: int = 3,
                     cell_jitter_frac: float = 0.2,
                     arrangement: str = "random") -> ElementState:
    """Sample one prototype frame.  `n` and `use_grid` may be traced;
    `arrangement` is static: 'random' | 'horizontal' | 'vertical' |
    'diagonal' | 'circular' (reference src/sample.py:90-146; the reference
    pipeline itself only ever samples 'random', src/sample.py:46-47)."""
    k_n, k_cells, k_kind, k_fill, k_stroke, k_angle, k_color, \
        k_gj, k_size, k_pos, k_pj = jax.random.split(key, 11)

    if n is None:
        n = jax.random.randint(k_n, (), 1, 4)
    n = jnp.maximum(1, jnp.asarray(n))
    E = max_elems
    slot = jnp.arange(E)
    valid = slot < n

    # ---- grid-mode placement ----
    cell_w = W / grid_size
    cell_h = H / grid_size
    cell_short = min(cell_w, cell_h)
    n_cells = grid_size * grid_size
    perm = jax.random.permutation(k_cells, n_cells)
    cell = perm[jnp.minimum(slot, n_cells - 1)]
    g_col = cell % grid_size
    g_row = cell // grid_size
    g_cx = jnp.round((g_col + 0.5) * cell_w)
    g_cy = jnp.round((g_row + 0.5) * cell_h)
    jit = cell_jitter_frac * cell_short
    g_jit = jnp.round(jax.random.uniform(k_gj, (E, 2), minval=-jit, maxval=jit))
    g_cx = jnp.clip(g_cx + g_jit[:, 0], 0, W)
    g_cy = jnp.clip(g_cy + g_jit[:, 1], 0, H)
    g_size = jnp.full((E,), float(max(8, min(round(cell_short * 0.6), min(W, H)))))

    # ---- non-grid 'random' arrangement ----
    base = min(W, H) // 4
    var = base // 3
    r_size = jnp.maximum(6.0, base + jax.random.randint(
        k_size, (E,), -var, var + 1).astype(jnp.float32))
    lo = r_size / 2 + 5
    hi_x = jnp.maximum(W - r_size / 2 - 5, lo)
    hi_y = jnp.maximum(H - r_size / 2 - 5, lo)
    u = jax.random.uniform(k_pos, (E, 2))
    r_cx = jnp.floor(lo + u[:, 0] * (hi_x - lo + 1))
    r_cy = jnp.floor(lo + u[:, 1] * (hi_y - lo + 1))
    pj = jnp.minimum(r_size // 4, 10)
    pj_draw = jnp.floor(jax.random.uniform(k_pj, (E, 2)) * (2 * pj[:, None] + 1)) - pj[:, None]
    if arrangement == "random":
        r_cx = jnp.clip(r_cx + pj_draw[:, 0], lo, hi_x)
        r_cy = jnp.clip(r_cy + pj_draw[:, 1], lo, hi_y)
    else:
        # deterministic layouts (reference src/sample.py:86-146): evenly
        # spaced along a line / circle, then the same jitter + clamp as the
        # random branch (src/sample.py:174-183)
        margin = jnp.max(jnp.where(valid, r_size, 0.0)) // 2 + 10
        i = slot.astype(jnp.float32)
        nm1 = jnp.maximum(n - 1, 1).astype(jnp.float32)
        sx = (W - 2 * margin) / nm1
        sy = (H - 2 * margin) / nm1
        if arrangement == "horizontal":
            ax, ay = jnp.floor(margin + i * sx), jnp.full((E,), float(H // 2))
        elif arrangement == "vertical":
            ax, ay = jnp.full((E,), float(W // 2)), jnp.floor(margin + i * sy)
        elif arrangement == "diagonal":
            ax, ay = jnp.floor(margin + i * sx), jnp.floor(margin + i * sy)
        elif arrangement == "circular":
            rad = min(W, H) // 4
            th = 2.0 * jnp.pi * i / jnp.maximum(n, 1).astype(jnp.float32)
            ax = jnp.floor(W // 2 + rad * jnp.cos(th))
            ay = jnp.floor(H // 2 + rad * jnp.sin(th))
        else:
            raise ValueError(f"unknown arrangement {arrangement!r}")
        if arrangement != "circular":  # single element centers (ref :92-95)
            ax = jnp.where(n == 1, float(W // 2), ax)
            ay = jnp.where(n == 1, float(H // 2), ay)
        r_cx = jnp.clip(ax + pj_draw[:, 0], lo, hi_x)
        r_cy = jnp.clip(ay + pj_draw[:, 1], lo, hi_y)

    use_grid = jnp.asarray(use_grid)
    cx = jnp.where(use_grid, g_cx, r_cx)
    cy = jnp.where(use_grid, g_cy, r_cy)
    size = jnp.where(use_grid, g_size, r_size)

    # ---- per-element attributes ----
    kind = jax.random.randint(k_kind, (E,), 0, NKINDS)
    fill = jax.random.uniform(k_fill, (E,)) < (2.0 / 3.0)
    stroke = jax.random.randint(k_stroke, (E,), 1, 4).astype(jnp.float32)
    angle = jnp.asarray(ANGLE_CHOICES)[jax.random.randint(k_angle, (E,), 0, 5)]
    angle = jnp.where(kind == CIRCLE, 0.0, angle)
    color = jnp.floor(jax.random.uniform(k_color, (E, 3), minval=30.0, maxval=220.0))

    st = empty_state(max_elems)
    st = st._replace(
        kind=jnp.where(valid, kind, 0),
        size=jnp.where(valid, size, 0.0),
        fill=fill & valid,
        stroke=jnp.where(valid, stroke, 1.0),
        cx=jnp.where(valid, cx, 0.0),
        cy=jnp.where(valid, cy, 0.0),
        angle=jnp.where(valid, angle, 0.0),
        color=jnp.where(valid[:, None], color, 0.0),
        valid=valid,
    )
    return recompute_bbox_from_center(st, W, H)
