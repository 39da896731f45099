# renderer.py — multigraph scene rasterizer (device data plane).
"""Batched rasterization of multigraph scenes.

Replaces the reference's matplotlib/Agg figure rendering
(multigraph_generation/generator.py:488-493,250-259) with a jitted SDF pass:

- shapes are outline-only polygon strokes (the style enhancer forces
  facecolor 'none', multigraph_generation/style.py:37);
- occlusion masks are SDF algebra: 'cut' keeps only original-boundary
  pixels outside the mask union; 'replace_boundary' additionally strokes
  the mask boundary inside the base shape
  (multigraph_generation/single_variants.py:612-633);
- decoration lines are distance-to-segment stroke bands;
- the data->pixel affine and the stroke AA model are calibrated against
  matplotlib: measured Agg cross sections fit
  alpha = style_alpha * clip(lw_px/2 + 0.5 - dist_px, 0, 1),
  and the transform for the reference's 8x8in/±5 bounds figure is
  x_px = (410 + 61.6x) * dpi/100 (matplotlib's constants, pinned in
  ``data_to_pixel_transform``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .scene import MAX_SHAPES, MAX_MASKS, MAX_LINES

# figure background: axis('off') hides the axes facecolor patch, so the
# saved image is the white figure facecolor (reference quirk — the
# '#f8f9fa' set at generator.py:491 never shows).
BG = (255.0, 255.0, 255.0)

# matplotlib's data->display transform of the reference figure (8x8 in at
# its 100 dpi, ax.set_aspect('equal'), ax.axis('off'), limits +-5;
# multigraph_generation/generator.py:488-493): data (0, 0) lands at display
# (410, 396) and (1, 0) at x = 471.6.  These are the values matplotlib
# 3.x computes (tests/test_multigraph.py checks them against it).
_FIG_DPI = 100.0
_ORIGIN_PX = (410.0, 396.0)
_UNIT_X_PX = 471.6


def data_to_pixel_transform(dpi: int):
    """(scale, x0, y0, size_px): x_px = x0 + scale*x ; y_disp = y0 + scale*y;
    row = size_px - y_disp.  Matplotlib's transform, rescaled to ``dpi``
    with matplotlib's own arithmetic."""
    k = dpi / _FIG_DPI
    return (float((_UNIT_X_PX - _ORIGIN_PX[0]) * k), float(_ORIGIN_PX[0] * k),
            float(_ORIGIN_PX[1] * k), int(8 * dpi))


def _poly_sdf(px, py, verts):
    """Signed distance of pixels [H,W] to polygon [V,2] (negative inside).

    Chunked over edges (see ops/raster._polygon_field): at the production
    1600^2 canvas an un-chunked [H, W, 64] broadcast would be 650 MB per
    shape and OOM HBM for any real batch."""
    from ...ops.raster import _polygon_field
    dist, inside = _polygon_field(px, py, verts)
    return jnp.where(inside, -dist, jnp.sqrt(dist * dist + 1e-20))


def _seg_dist(px, py, seg):
    x0, y0, x1, y1 = seg[0], seg[1], seg[2], seg[3]
    ex, ey = x1 - x0, y1 - y0
    inv = 1.0 / (ex * ex + ey * ey + 1e-12)
    t = jnp.clip(((px - x0) * ex + (py - y0) * ey) * inv, 0.0, 1.0)
    return jnp.hypot(px - (x0 + t * ex), py - (y0 + t * ey))


def _band(dist_px, lw_px, style_alpha):
    """Agg-calibrated AA: 1px linear ramp at halfwidth lw_px/2."""
    return style_alpha * jnp.clip(lw_px * 0.5 + 0.5 - dist_px, 0.0, 1.0)


def _over(canvas, color, alpha):
    a = alpha[..., None]
    return canvas * (1.0 - a) + color * a


def render_scene(scene, dpi: int = 200):
    """Render one scene dict (unbatched) to u8 [S, S, 3] RGB, S = 8*dpi."""
    scale, x0, y0, size_px = data_to_pixel_transform(dpi)
    H = W = size_px
    # pixel centers in DATA coordinates (y-up)
    c = jnp.arange(W, dtype=jnp.float32) + 0.5
    r = jnp.arange(H, dtype=jnp.float32) + 0.5
    px = ((c - x0) / scale)[None, :].repeat(H, 0)
    py = ((H - r - y0) / scale)[:, None].repeat(W, 1)
    lw_scale = dpi / 72.0  # points -> pixels

    canvas = jnp.broadcast_to(jnp.asarray(BG, jnp.float32), (H, W, 3))
    black = jnp.zeros(3, jnp.float32)

    # mask union SDF (in data units)
    mask_sdf = jnp.full((H, W), 1e9, jnp.float32)
    for m in range(MAX_MASKS):
        d = _poly_sdf(px, py, scene["mask_verts"][m])
        d = jnp.where(scene["mask_valid"][m], d, 1e9)
        mask_sdf = jnp.minimum(mask_sdf, d)
    has_mask = scene["mask_mode"] > 0
    is_replace = scene["mask_mode"] == 2

    # shape strokes (painter's order)
    for s in range(MAX_SHAPES):
        d = _poly_sdf(px, py, scene["shape_verts"][s])
        # optional radial gradient fill (style.py:68-119 capability):
        # color = lerp(c0, c1, r / r_max) inside the shape
        if "grad_valid" in scene:
            verts = scene["shape_verts"][s]
            ctr = jnp.mean(verts, axis=0)
            r = jnp.hypot(px - ctr[0], py - ctr[1])
            rmax = jnp.max(jnp.hypot(verts[:, 0] - ctr[0],
                                     verts[:, 1] - ctr[1])) + 1e-6
            tfrac = jnp.clip(r / rmax, 0.0, 1.0)[..., None]
            gcol = scene["grad_c0"][s] * (1 - tfrac) + scene["grad_c1"][s] * tfrac
            galpha = ((d < 0) & scene["grad_valid"][s] &
                      scene["shape_valid"][s]).astype(jnp.float32) \
                * scene["grad_alpha"][s]
            canvas = canvas * (1 - galpha[..., None]) + gcol * galpha[..., None]
        lw_px = scene["shape_lw"][s] * lw_scale
        alpha = _band(jnp.abs(d) * scale, lw_px, scene["shape_alpha"][s])
        # masks apply to shape 0 (single-shape pipeline): keep boundary
        # pixels outside the mask union only
        keep = jnp.where(has_mask & (s == 0), mask_sdf > 0, True)
        alpha = alpha * keep * scene["shape_valid"][s]
        canvas = _over(canvas, black, alpha)
        if s == 0:
            # replace_boundary: stroke the mask boundary inside the base
            m_alpha = _band(jnp.abs(mask_sdf) * scale, lw_px,
                            scene["shape_alpha"][s])
            m_alpha = m_alpha * (d < 0) * is_replace * scene["shape_valid"][s]
            canvas = _over(canvas, black, m_alpha)

    # decoration lines
    for k in range(MAX_LINES):
        dist = _seg_dist(px, py, scene["line_pts"][k])
        lw_px = scene["line_lw"][k] * lw_scale
        alpha = _band(dist * scale, lw_px, scene["line_alpha"][k])
        alpha = alpha * scene["line_valid"][k]
        canvas = _over(canvas, scene["line_color"][k], alpha)

    return jnp.clip(jnp.round(canvas), 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("dpi",))
def render_scene_batch(batch, dpi: int = 200):
    return jax.vmap(lambda s: render_scene(s, dpi))(batch)
