# compose.py — question-grid composition (device resize + static overlay).
"""Composes the final puzzle grid (sequence row + query cell + options row).

Rebuilds reference src/layout.py:49-192 as one device program:

- cell geometry, borders, row offsets are compile-time constants per
  (canvas, sequence length, option count) — computed once on host;
- all text (S0..Sn / A..D labels, the '?' query glyph) and the 1px borders
  are pre-rendered host-side into ONE static RGBA overlay with the Hershey
  simplex strokes of ops/hershey.py (the reference's cv2.putText font and
  metrics) and composited on device with a single blend — no per-sample
  text rasterization;
- the per-cell `fit_into_cell` resize (reference src/layout.py:17-31) is an
  exact area resample (cv2.INTER_AREA) as two matmuls.

The device path is one jittable function over a whole batch of samples.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Dict

import numpy as np
import jax
import jax.numpy as jnp

from . import hershey


@dataclass
class GridLayout:
    """Static layout for one (W, H, n_states, num_options) combination."""
    W: int
    H: int
    n_states: int          # sequence cells shown (excl. query)
    num_options: int
    margin: int
    padding_v: int
    cell_size: int
    grid_h: int
    seq_offset_x: int
    opt_offset_x: int
    top_y: int
    bottom_y: int
    show_labels: bool
    show_border: bool
    bg_color: tuple
    overlay_rgb: np.ndarray = field(repr=False)   # f32 [grid_h, W, 3]
    overlay_a: np.ndarray = field(repr=False)     # f32 [grid_h, W]
    query_patch: np.ndarray = field(repr=False)   # u8  [cell, cell, 3]
    cells_meta: List[Dict] = field(repr=False)
    # u8 overlay for the EXACT integer blend shared by the device
    # compositor and the host/C PNG encoder (apply_overlay_u8): the
    # transfer codec ships the pre-overlay canvas (the static overlay is
    # ~37% of a composed grid's RLE runs) and either side must produce
    # identical pixels
    overlay_rgb_u8: np.ndarray = field(repr=False, default=None)  # u8 [gh, W, 3]
    overlay_a8: np.ndarray = field(repr=False, default=None)      # u8 [gh, W]


def _put_text_alpha(rgb, a, text, org, font_scale, thickness):
    """Rasterize black Hershey text into the (rgb, a) overlay buffers."""
    h, w = a.shape
    tmp = np.full((h, w), 255, np.uint8)
    hershey.put_text(tmp, text, org, font_scale, 0, thickness)
    ta = 1.0 - tmp.astype(np.float32) / 255.0
    # text color black: new_rgb = rgb*(1-ta) + 0*ta, alpha = a + ta*(1-a)
    rgb *= (1.0 - ta)[..., None]
    a += ta * (1.0 - a)


def _make_query_patch(cell_size: int) -> np.ndarray:
    """'?' cell laid out like reference make_query_image
    (src/layout.py:33-47): same metrics and placement, Hershey strokes."""
    im = np.full((cell_size, cell_size, 3), 255, np.uint8)
    thickness = max(1, cell_size // 80)
    font_scale = cell_size / 100.0
    (tw, th), _ = hershey.text_size("?", font_scale, thickness)
    if tw > cell_size * 0.8:
        font_scale = font_scale * (cell_size * 0.8 / tw)
        (tw, th), _ = hershey.text_size("?", font_scale, thickness)
    x = (cell_size - tw) // 2
    y = (cell_size + th) // 2
    hershey.put_text(im, "?", (x, y), font_scale, (0, 0, 0), thickness)
    return im


def build_layout(W: int, H: int, n_states: int, num_options: int,
                 margin: int = 20, padding_v: int = 20,
                 show_labels: bool = True, show_border: bool = True,
                 bg_color=(255, 255, 255)) -> GridLayout:
    """Compute the static layout + overlay (reference src/layout.py:49-192)."""
    cols_seq = n_states + 1
    cols_opt = num_options
    max_cell_w = (W - 2 * margin) // max(1, max(cols_seq, cols_opt))
    max_cell_h = (H - 2 * margin - padding_v) // 2
    cell = max(1, min(max_cell_w, max_cell_h))
    grid_h = 2 * cell + padding_v + 2 * margin
    seq_off = (W - cols_seq * cell) // 2
    opt_off = (W - cols_opt * cell) // 2
    top_y = margin
    bottom_y = top_y + cell + padding_v

    overlay_rgb = np.zeros((grid_h, W, 3), np.float32)
    overlay_a = np.zeros((grid_h, W), np.float32)
    font_scale = max(0.25, min(0.8, cell / 240.0))

    query_patch = _make_query_patch(cell)

    cells_meta: List[Dict] = []

    def border(x, y):
        if not show_border:
            return
        # 1px black rectangle, alpha 1 (cv2.rectangle thickness 1)
        overlay_rgb[y, x:x + cell] = 0
        overlay_a[y, x:x + cell] = 1
        overlay_rgb[y + cell - 1, x:x + cell] = 0
        overlay_a[y + cell - 1, x:x + cell] = 1
        overlay_rgb[y:y + cell, x] = 0
        overlay_a[y:y + cell, x] = 1
        overlay_rgb[y:y + cell, x + cell - 1] = 0
        overlay_a[y:y + cell, x + cell - 1] = 1

    # sequence row + query
    for i in range(cols_seq):
        x = seq_off + i * cell
        y = top_y
        label = f"S{i}" if show_labels else ""
        is_query = i == n_states
        if is_query:
            # query cell content is static: stamp the whole patch as overlay
            overlay_rgb[y:y + cell, x:x + cell] = query_patch.astype(np.float32)
            overlay_a[y:y + cell, x:x + cell] = 1.0
        border(x, y)
        if show_labels and label:
            _put_text_alpha(overlay_rgb, overlay_a, label,
                            (x + 3, y + cell + int(12 * font_scale) + 6),
                            font_scale, 1)
        cells_meta.append({
            "r": 0, "c": i, "label": label,
            "bbox": [int(x), int(y), int(cell), int(cell)],
            "is_query": bool(is_query),
        })

    # options row
    for i in range(cols_opt):
        x = opt_off + i * cell
        y = bottom_y
        label = chr(65 + i) if show_labels else ""
        border(x, y)
        if show_labels and label:
            _put_text_alpha(overlay_rgb, overlay_a, label,
                            (x + 3, y + cell + int(12 * font_scale) + 6),
                            font_scale, 1)
        cells_meta.append({
            "r": 1, "c": i, "label": label,
            "bbox": [int(x), int(y), int(cell), int(cell)],
        })

    return GridLayout(W=W, H=H, n_states=n_states, num_options=num_options,
                      margin=margin, padding_v=padding_v, cell_size=cell,
                      grid_h=grid_h, seq_offset_x=seq_off, opt_offset_x=opt_off,
                      top_y=top_y, bottom_y=bottom_y, show_labels=show_labels,
                      show_border=show_border, bg_color=tuple(bg_color),
                      overlay_rgb=overlay_rgb, overlay_a=overlay_a,
                      query_patch=query_patch, cells_meta=cells_meta,
                      overlay_rgb_u8=np.clip(np.round(overlay_rgb), 0,
                                             255).astype(np.uint8),
                      overlay_a8=np.clip(np.round(overlay_a * 255.0), 0,
                                         255).astype(np.uint8))


from functools import lru_cache


@lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] pixel-coverage weights: exact area resampling.

    Each output pixel averages the input pixels its footprint overlaps,
    weighted by overlap length — precisely cv2.INTER_AREA's downscale
    model (the reference's fit_into_cell interpolation,
    src/layout.py:26).  Rows sum to 1.  Computed host-side at trace time
    (static shapes); applied as two matmuls.
    """
    sx = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        a, b = o * sx, (o + 1) * sx
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), n_in)):
            w[o, i] = min(b, i + 1.0) - max(a, float(i))
        w[o] /= (b - a)
    return w


def fit_into_cell(img: jnp.ndarray, cell: int) -> jnp.ndarray:
    """Aspect-preserving resize onto a white square cell (device).

    Mirrors reference src/layout.py:17-31 including its interpolation
    choice: INTER_AREA (exact box filter, via `_area_weights` matmuls) for
    downscale, cubic for upscale; shapes are static so the scale arithmetic
    happens at trace time.
    """
    Hs, Ws = img.shape[:2]
    scale = min(cell / Ws, cell / Hs)
    new_w = max(1, int(round(Ws * scale)))
    new_h = max(1, int(round(Hs * scale)))
    if scale < 1.0:
        wh = jnp.asarray(_area_weights(Hs, new_h))
        ww = jnp.asarray(_area_weights(Ws, new_w))
        # full f32 precision: a TF32 product rounds 0-255 pixel values
        hp = jax.lax.Precision.HIGHEST
        t = jnp.einsum("oh,hwc->owc", wh, img.astype(jnp.float32),
                       precision=hp)
        resized = jnp.einsum("pw,owc->opc", ww, t, precision=hp)
    else:
        resized = jax.image.resize(img.astype(jnp.float32),
                                   (new_h, new_w, 3), method="cubic")
    patch = jnp.full((cell, cell, 3), 255.0, jnp.float32)
    ox = (cell - new_w) // 2
    oy = (cell - new_h) // 2
    return jax.lax.dynamic_update_slice(patch, resized, (oy, ox, 0))


def apply_overlay_u8(content, ov_rgb_u8, a8):
    """EXACT integer alpha blend of the static overlay onto u8 content:
    out = (content*(255-a8) + overlay*a8 + 127) // 255.

    Pure integer math so the device compositor (jnp), the numpy decode
    fallback, and the C PNG encoder (fastpng_write_rle with overlay)
    produce bit-identical pixels — a frame gives the same bytes whether
    it travels as an RLE stream or as a raw overflow fetch.  Works on
    numpy or jnp arrays."""
    xp = jnp if isinstance(content, jnp.ndarray) else np
    c = content.astype(xp.int32)
    o = ov_rgb_u8.astype(xp.int32)
    a = a8.astype(xp.int32)[..., None]
    return ((c * (255 - a) + o * a + 127) // 255).astype(xp.uint8)


def compose_grid(layout: GridLayout, state_imgs: jnp.ndarray,
                 option_imgs: jnp.ndarray, return_pre: bool = False):
    """Device composition of one sample's grid.

    state_imgs: u8 [n_states, H, W, 3] (query cell added from the overlay);
    option_imgs: u8 [num_options, H, W, 3].
    Returns u8 [grid_h, W, 3]; with return_pre also the PRE-overlay
    canvas — the transfer codec ships that (the static overlay is ~37% of
    a composed grid's runs; measured 8729 -> 5485 on a production sample)
    and the host re-applies the overlay via apply_overlay_u8."""
    cell = layout.cell_size
    bgr = np.asarray(layout.bg_color, np.float32)
    canvas = jnp.broadcast_to(jnp.asarray(bgr), (layout.grid_h, layout.W, 3))

    for i in range(layout.n_states):
        patch = fit_into_cell(state_imgs[i], cell)
        canvas = jax.lax.dynamic_update_slice(
            canvas, patch, (layout.top_y, layout.seq_offset_x + i * cell, 0))
    for i in range(layout.num_options):
        patch = fit_into_cell(option_imgs[i], cell)
        canvas = jax.lax.dynamic_update_slice(
            canvas, patch, (layout.bottom_y, layout.opt_offset_x + i * cell, 0))

    pre = jnp.clip(jnp.round(canvas), 0, 255).astype(jnp.uint8)
    grid = apply_overlay_u8(pre, jnp.asarray(layout.overlay_rgb_u8),
                            jnp.asarray(layout.overlay_a8))
    return (grid, pre) if return_pre else grid
