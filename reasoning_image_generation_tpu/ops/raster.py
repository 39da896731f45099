# raster.py — batched SDF rasterizer (jnp reference implementation).
"""Renders ElementState frames to images in one XLA program.

This replaces the reference's per-shape OpenCV mutation loop
(``Shape.draw``, reference src/shapes.py:209-656;
``_render_elements_to_canvas``, reference src/generator.py:66-124) with a
functional design:

- every kind's outline is a padded polygon from ``geometry.VERTS_UNIT``;
  circle and crescent are analytic signed-distance fields;
- fills are hard-thresholded at pixel centers (cv2.fillPoly does unaliased
  scan conversion), outlines are 1px-ramp anti-aliased bands (cv2 LINE_AA);
- painter's-order compositing over the element axis matches the reference's
  sequential draw order;
- toroidal wrap-around is a coordinate ``mod`` to the nearest periodic copy
  instead of the reference's 3x3 redraw loop (reference src/shapes.py:369-375)
  — equivalent whenever a shape is smaller than the canvas, which the
  prototype sampler guarantees;
- grid snap + grid lines mirror reference src/generator.py:96-122.

All functions are jit/vmap-friendly: static shapes, no data-dependent Python
control flow.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.state import ElementState
from . import geometry as G

_EPS = 1e-9


def _lanczos4_down2_weights(n_in: int):
    """[n_in//2, n_in] weights reproducing cv2.resize INTER_LANCZOS4 for an
    exact 2x downscale (the reference 'hq' mode's final step,
    src/shapes.py:72-81).  cv2 does NOT stretch the kernel when
    downscaling: each output pixel o samples input coordinate 2o+0.5 with
    the 8-tap Lanczos4 kernel at fixed offsets ±0.5..±3.5, borders
    replicated.  Verified maxdiff <= 1 vs cv2 on real renders."""
    import numpy as np
    d = np.arange(-3, 5) - 0.5
    L = np.sinc(d) * np.sinc(d / 4.0)
    L /= L.sum()
    n_out = n_in // 2
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        for k in range(8):
            i = min(max(2 * o - 3 + k, 0), n_in - 1)
            w[o, i] += L[k]
    return w


def _rotate_flip(v: jnp.ndarray, angle_deg: jnp.ndarray,
                 flip_h: jnp.ndarray, flip_v: jnp.ndarray) -> jnp.ndarray:
    """Rotate unit verts clockwise-positive then flip, exactly as the
    reference's `_rotate_points` + `_apply_flip` (src/shapes.py:238-258)."""
    a = jnp.deg2rad(-angle_deg)
    ca, sa = jnp.cos(a), jnp.sin(a)
    x, y = v[..., 0], v[..., 1]
    xr = x * ca - y * sa
    yr = x * sa + y * ca
    xr = jnp.where(flip_h, -xr, xr)
    yr = jnp.where(flip_v, -yr, yr)
    return jnp.stack([xr, yr], axis=-1)


def element_verts(kind, size, angle, flip_h, flip_v, cx, cy):
    """Absolute, integer-rounded polygon vertices for one element.

    Returns (verts [NPART, MAX_VERTS, 2] f32, nv [NPART] i32).
    Rounding matches the reference's pts_to_arr_abs (src/shapes.py:278-280).
    """
    unit = jnp.asarray(G.VERTS_UNIT)[kind]          # [NPART, V, 2]
    nv = jnp.asarray(G.NV)[kind]                    # [NPART]
    half = size * 0.5
    v = _rotate_flip(unit, angle, flip_h, flip_v) * half
    v = v + jnp.stack([cx, cy])
    return jnp.round(v), nv


_EDGE_CHUNK = 8


def _edge_consts(verts):
    """Per-edge scalars of a padded polygon [..., V, 2] -> [..., 7, V].

    Edge k runs from vertex k to vertex k+1 (the last to vertex 0).  The
    rows are ax, ay (start), by (end y), ex, ey (direction), 1/|e|^2 and
    ex/ey, the inverse slope of the scanline crossing (ex/1 where ey == 0;
    such an edge never crosses).  Both renderers take these from here, so
    the divisions happen once per edge, in XLA, and the per-pixel work
    (``_edge_eval``) is multiplies and adds only."""
    b = jnp.roll(verts, -1, axis=-2)
    ax, ay = verts[..., 0], verts[..., 1]
    ex, ey = b[..., 0] - ax, b[..., 1] - ay
    inv_len2 = 1.0 / (ex * ex + ey * ey + _EPS)
    slope = ex / jnp.where(ey == 0, 1.0, ey)
    return jnp.stack([ax, ay, b[..., 1], ex, ey, inv_len2, slope], axis=-2)


def _edge_eval(px, py, ax, ay, by, ex, ey, inv_len2, slope):
    """Squared distance to one edge and its even-odd crossing flag."""
    pxe = px - ax
    pye = py - ay
    t = jnp.clip((pxe * ex + pye * ey) * inv_len2, 0.0, 1.0)
    dx = pxe - t * ex
    dy = pye - t * ey
    cross = ((ay > py) != (by > py)) & (px < ax + pye * slope)
    return dx * dx + dy * dy, cross


def _polygon_field(px, py, verts):
    """Unsigned distance + even-odd inside test for a padded polygon.

    px, py: [H, W] pixel coords; verts: [V, 2].
    Returns (dist [H, W], inside [H, W] bool).

    Edges are processed in chunks of _EDGE_CHUNK inside a fori_loop so the
    broadcast intermediate is [H, W, chunk] instead of [H, W, V] (a
    [H, W, V] broadcast is ~64 MB per element per frame at 512^2).
    """
    consts = _edge_consts(verts)                     # [7, V]
    n_chunks = verts.shape[0] // _EDGE_CHUNK

    def body(c, carry):
        d2, cross = carry
        e = jax.lax.dynamic_slice_in_dim(consts, c * _EDGE_CHUNK,
                                         _EDGE_CHUNK, axis=1)
        d2c, cc = _edge_eval(px[..., None], py[..., None], *e)
        d2 = jnp.minimum(d2, jnp.min(d2c, axis=-1))
        cross = cross + jnp.sum(cc.astype(jnp.int32), axis=-1)
        return d2, cross

    d2, crossings = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.full(px.shape, jnp.inf, jnp.float32),
         jnp.zeros(px.shape, jnp.int32)))
    return jnp.sqrt(d2), (crossings % 2) == 1


def _wrap(p, c, size):
    """Coordinate of the periodic copy of p nearest to c on a torus of
    ``size``: c + ((p - c + size/2) mod size) - size/2.

    The floored modulo multiplies by the constant 1/size and corrects the
    quotient with exact compares instead of dividing, so every backend
    (XLA on CPU or GPU, the Triton kernel) rounds it the same way."""
    u = p - c + size * 0.5
    r = u - jnp.floor(u * (1.0 / size)) * size
    r = jnp.where(r < 0.0, r + size, r)
    r = jnp.where(r >= size, r - size, r)
    return c + r - size * 0.5


def _dist(dx, dy):
    """Euclidean length without the division inside ``jnp.hypot``."""
    return jnp.sqrt(dx * dx + dy * dy)


def _full_radius(width):
    """Full-coverage half-width of a cv2 LINE_AA stroke of ``width``."""
    return jnp.where(width <= 1.0, 0.0, jnp.ceil(width * 0.5))


def _band_alpha(dist, r_full):
    return jnp.clip((r_full + 1.28 - dist) * (1.0 / 1.28), 0.0, 1.0)


def _stroke_alpha(dist, width):
    """AA band centered on the zero level set, calibrated to cv2 LINE_AA.

    Measured cross-sections of cv2.polylines with LINE_AA (thickness t in
    {1,2,3,4,6,8}): full coverage out to |d| = ceil(t/2) for t >= 2 (0 for
    t=1), then a ~1.3px linear fringe (alpha ~0.22 one pixel past the full
    band).  Fitted: alpha = clip((ceil(t/2) + 1.28 - d) / 1.28, 0, 1).
    Identical to the round-1 (t + 0.28 - d)/1.28 model for t in {1,2,3}
    (the production stroke range); corrects the band width for t >= 4,
    which the 2x-supersampled 'hq' mode hits (strokes scale with the
    supersample ratio, reference src/shapes.py:277).
    """
    return _band_alpha(dist, _full_radius(width))


def _round_u8(x):
    """Round half to even, clip to 0..255 and cast to u8 (``jnp.round``
    semantics from floor and compares, which every backend lowers)."""
    fl = jnp.floor(x)
    fr = x - fl
    odd = (fl - 2.0 * jnp.floor(fl * 0.5)) == 1.0
    up = (fr > 0.5) | ((fr == 0.5) & odd)
    return jnp.clip(jnp.where(up, fl + 1.0, fl), 0.0, 255.0).astype(jnp.uint8)


def _over(canvas, color, alpha):
    """alpha-composite a flat color over the canvas. alpha [H,W], color [3]."""
    a = alpha[..., None]
    return canvas * (1.0 - a) + color * a


def composite_element(canvas, px, py, W, H, kind, size, fill, stroke,
                      cx, cy, angle, flip_h, flip_v, color, valid,
                      soft_blur: float = 0.0, outline_color=None):
    """Draw one element onto the canvas (f32 [H, W, 3], 0-255).

    soft_blur > 0 reproduces the reference's 'soft' antialias mode: the
    polygon fill mask is Gaussian-blurred before compositing
    (reference src/shapes.py:58-69); modeled as a linear alpha ramp of
    comparable width on the SDF.

    outline_color defaults to black, the pipeline's choice
    (reference src/generator.py:106); Shape.draw exposes it as a
    parameter (reference src/shapes.py:209)."""
    outline = (jnp.zeros(3, jnp.float32) if outline_color is None
               else jnp.asarray(outline_color, jnp.float32))
    half = size * 0.5
    stroke_w = jnp.maximum(1.0, jnp.round(stroke))

    # toroidal wrap: evaluate at the nearest periodic copy.  The reference
    # redraws copies only at the 3x3 offsets {-W,0,W}x{-H,0,H}
    # (src/shapes.py:369-375), so an element whose center has drifted >= 2
    # canvases away (possible: rule_translate never clips centers,
    # src/rules.py:160-173) is NOT drawn — `wrap_ok` gates those out to
    # stay pixel-faithful.
    pxw = _wrap(px, cx, float(W))
    pyw = _wrap(py, cy, float(H))
    wrap_ok = ((jnp.abs(px - pxw) <= float(W)) &
               (jnp.abs(py - pyw) <= float(H)))

    # ---- generic polygon path (9 of 11 kinds) ----
    verts, nv = element_verts(kind, size, angle, flip_h, flip_v, cx, cy)
    d0, in0 = _polygon_field(pxw, pyw, verts[0])
    d1, in1 = _polygon_field(pxw, pyw, verts[1])
    has_p1 = nv[1] > 0

    # ---- analytic circle ----
    r_circ = jnp.maximum(1.0, jnp.round(half))
    d_circ = _dist(pxw - cx, pyw - cy) - r_circ

    # ---- analytic crescent ----
    r_out = jnp.maximum(1.0, jnp.round(half))
    r_in = jnp.round(r_out * G.CRESCENT_INNER_R)
    off = jnp.round(r_out * G.CRESCENT_OFFSET)
    a = jnp.deg2rad(-angle)
    icx = cx + jnp.round(off * jnp.cos(a))
    icy = cy + jnp.round(off * jnp.sin(a))
    d_cout = _dist(pxw - cx, pyw - cy) - r_out
    d_cin = _dist(pxw - icx, pyw - icy) - r_in

    is_circle = kind == G.CIRCLE
    is_crescent = kind == G.CRESCENT

    # fill coverage (hard edges, like cv2.fillPoly / mask composites);
    # soft mode widens the polygon fill edge into a blur-like ramp
    sd0 = jnp.where(in0, -d0, d0)
    sd1 = jnp.where(in1, -d1, d1)
    if soft_blur > 0:
        # Gaussian-blurred hard mask ≙ erf of the signed distance: cv2's
        # GaussianBlur(sigma=0) derives sigma = 0.3*((k-1)/2 - 1) + 0.8
        # from the kernel size (reference draw_soft_filled_poly,
        # src/shapes.py:58-69), and blurring a half-plane step with that
        # Gaussian gives alpha(d) = 0.5*erfc(d / (sigma*sqrt(2))).
        k = soft_blur if soft_blur % 2 == 1 else soft_blur + 1
        sigma = 0.3 * ((k - 1) * 0.5 - 1.0) + 0.8
        inv = 1.0 / (sigma * jnp.sqrt(2.0))
        soft_a = lambda sd: 0.5 * (1.0 - jax.scipy.special.erf(sd * inv))
        fill0_a = soft_a(sd0)
        fill1_a = soft_a(sd1) * has_p1
    else:
        fill0_a = in0.astype(jnp.float32)
        fill1_a = (in1 & has_p1).astype(jnp.float32)
    fill0 = jnp.where(is_circle, (d_circ < 0).astype(jnp.float32),
                      jnp.where(is_crescent,
                                ((d_cout < 0) & (d_cin >= 0)).astype(jnp.float32),
                                fill0_a))
    fill1 = fill1_a

    # stroke coverage (AA bands, like cv2 LINE_AA outlines)
    s0 = jnp.where(is_circle, _stroke_alpha(jnp.abs(d_circ), stroke_w),
                   jnp.where(is_crescent,
                             jnp.maximum(_stroke_alpha(jnp.abs(d_cout), stroke_w),
                                         _stroke_alpha(jnp.abs(d_cin), stroke_w)),
                             _stroke_alpha(d0, stroke_w)))
    s1 = _stroke_alpha(d1, stroke_w) * has_p1

    valid_f = valid.astype(jnp.float32) * wrap_ok.astype(jnp.float32)
    fill_f = fill.astype(jnp.float32) * valid_f

    # painter's order inside the element: part0 fill, part0 stroke,
    # part1 fill, part1 stroke (matches the reference's plus draw order,
    # src/shapes.py:477-509)
    canvas = _over(canvas, color, fill0 * fill_f)
    canvas = _over(canvas, outline, s0 * valid_f)
    canvas = _over(canvas, color, fill1 * fill_f)
    canvas = _over(canvas, outline, s1 * valid_f)
    return canvas


def render_frame(state: ElementState, W: int, H: int,
                 bg_color=(255.0, 255.0, 255.0),
                 use_grid=False, grid_size: int = 3,
                 honor_flip: bool = False,
                 antialias_mode: str = "fast", scale: int = 2,
                 soft_blur: int = 7) -> jnp.ndarray:
    """Render one frame (unbatched ElementState) to u8 [H, W, 3] RGB.

    `use_grid` may be a traced boolean; grid snap + 1px grid lines follow
    reference src/generator.py:96-122.

    `honor_flip=False` replicates a reference quirk: its renderer reads
    ``el.get('flip_mode')`` which the pipeline never sets (elements carry
    ``el['flip']``), so mirror state is metadata-only and never rendered
    (reference src/generator.py:94).  Pass True to actually mirror the
    geometry (the Shape.draw ``flip_mode`` capability,
    reference src/shapes.py:247-258).

    antialias_mode mirrors Shape.draw's three AA strategies
    (reference src/shapes.py:658-665):
      'fast' — hard fills + AA outlines (default, cv2 parity path);
      'soft' — blur-widened polygon fill masks (src/shapes.py:58-69);
      'hq'   — `scale`x supersampled render + antialiased downsample
               (src/shapes.py:72-81), grid lines applied at target res.
    """
    if antialias_mode == "hq" and scale > 1:
        # grid snap applies to element centers BEFORE supersampling
        ug = jnp.asarray(use_grid)
        cw, ch = W / grid_size, H / grid_size
        col = jnp.clip(jnp.floor(state.cx / cw), 0, grid_size - 1)
        row = jnp.clip(jnp.floor(state.cy / ch), 0, grid_size - 1)
        snap_cx = jnp.where(ug, jnp.trunc((col + 0.5) * cw), state.cx)
        snap_cy = jnp.where(ug, jnp.trunc((row + 0.5) * ch), state.cy)
        big = state._replace(cx=snap_cx * scale, cy=snap_cy * scale,
                             size=state.size * scale,
                             stroke=state.stroke * scale)
        hi = render_frame(big, W * scale, H * scale, bg_color=bg_color,
                          use_grid=False, grid_size=grid_size,
                          honor_flip=honor_flip, antialias_mode="fast")
        if scale == 2:
            # exact cv2 INTER_LANCZOS4 2x downscale as two matmuls; full
            # f32 precision (a TF32 product would move 0-255 pixel values)
            wh = jnp.asarray(_lanczos4_down2_weights(H * 2))
            ww = jnp.asarray(_lanczos4_down2_weights(W * 2))
            hp = jax.lax.Precision.HIGHEST
            t = jnp.einsum("oh,hwc->owc", wh, hi.astype(jnp.float32),
                           precision=hp)
            lo = jnp.einsum("pw,owc->opc", ww, t, precision=hp)
        else:
            lo = jax.image.resize(hi.astype(jnp.float32), (H, W, 3),
                                  "lanczos3", antialias=False)
        # grid snap/lines happen at target resolution
        canvas = lo
        use_grid_arr = jnp.asarray(use_grid)
        px = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
        py = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
        xs = jnp.round(jnp.arange(1, grid_size) * W / grid_size)
        ys = jnp.round(jnp.arange(1, grid_size) * H / grid_size)
        on_line = (jnp.any(px[..., None] == xs, axis=-1) |
                   jnp.any(py[..., None] == ys, axis=-1))
        la = (on_line & use_grid_arr).astype(jnp.float32)
        canvas = _over(canvas, jnp.zeros(3, jnp.float32), la)
        return jnp.clip(jnp.round(canvas), 0, 255).astype(jnp.uint8)
    px = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    py = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    canvas = jnp.broadcast_to(jnp.asarray(bg_color, jnp.float32), (H, W, 3))

    use_grid = jnp.asarray(use_grid)
    cell_w = W / grid_size
    cell_h = H / grid_size
    col = jnp.clip(jnp.floor(state.cx / cell_w), 0, grid_size - 1)
    row = jnp.clip(jnp.floor(state.cy / cell_h), 0, grid_size - 1)
    cx = jnp.where(use_grid, jnp.trunc((col + 0.5) * cell_w), state.cx)
    cy = jnp.where(use_grid, jnp.trunc((row + 0.5) * cell_h), state.cy)
    # the reference casts angle to int at render time (src/generator.py:93)
    angle = jnp.trunc(state.angle)

    fh = state.flip_h if honor_flip else jnp.zeros_like(state.flip_h)
    fv = state.flip_v if honor_flip else jnp.zeros_like(state.flip_v)

    sb = float(soft_blur) if antialias_mode == "soft" else 0.0
    E = state.num_slots
    for e in range(E):  # static unroll: painter's order over slots
        canvas = composite_element(
            canvas, px, py, W, H,
            state.kind[e], state.size[e], state.fill[e], state.stroke[e],
            cx[e], cy[e], angle[e], fh[e], fv[e],
            state.color[e], state.valid[e], soft_blur=sb)

    # grid lines (1px black), reference src/generator.py:111-122
    xs = jnp.round(jnp.arange(1, grid_size) * W / grid_size)
    ys = jnp.round(jnp.arange(1, grid_size) * H / grid_size)
    on_line = (jnp.any(px[..., None] == xs, axis=-1) |
               jnp.any(py[..., None] == ys, axis=-1))
    line_alpha = (on_line & use_grid).astype(jnp.float32)
    canvas = _over(canvas, jnp.zeros(3, jnp.float32), line_alpha)

    return jnp.clip(jnp.round(canvas), 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnums=(1, 2, 4))
def render_batch(states: ElementState, W: int, H: int, use_grid, grid_size: int = 3):
    """vmapped render: states with leading batch dim -> u8 [B, H, W, 3]."""
    return jax.vmap(lambda s, g: render_frame(s, W, H, use_grid=g,
                                              grid_size=grid_size))(states, use_grid)
